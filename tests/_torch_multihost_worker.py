"""One rank of tests/test_torch_multihost.py's 2-process CPU mesh (gloo):
runs each case of ``CASES`` on ``multihost.global_mesh`` and prints one
JSON line: per case, the sha256 of every field of each block this rank
holds, the converged round(s) and the metrics."""

import hashlib
import json
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

from aiocluster_torch import SimConfig, Simulator, SweepSimulator  # noqa: E402
from aiocluster_torch.parallel import multihost  # noqa: E402
from aiocluster_torch.sim.state import STATE_FIELDS  # noqa: E402

N = 256
NARROW = dict(version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16")
# name: (config, blocks per rank, sweep lanes or None)
CASES = {
    "kernels": (SimConfig(n_nodes=N, keys_per_node=4, fanout=3, budget=48, use_pallas=True,
                          **NARROW), 1, None),
    "greedy": (SimConfig(n_nodes=N, keys_per_node=4, fanout=2, budget=40,
                         budget_policy="greedy", **NARROW), 2, None),
    "view": (SimConfig(n_nodes=N, keys_per_node=4, fanout=2, budget=40, pairing="choice",
                       peer_mode="view", **NARROW), 2, None),
    "sweep": (SimConfig(n_nodes=N, keys_per_node=4, fanout=3, budget=48, **NARROW), 2,
              dict(phi_threshold=[7.0, 9.0], writes_per_round=[0, 1])),
}
HORIZON = 40


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous().reshape(-1)
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def digests(blocks) -> list[dict]:
    """The sha256 of every field of each block."""
    return [{f: hashlib.sha256(_bytes(getattr(b, f))).hexdigest() for f in STATE_FIELDS}
            for b in blocks]


def run_case(name, mesh_of):
    cfg, per_rank, lanes = CASES[name]
    mesh = mesh_of(per_rank)
    if lanes is None:
        sim = Simulator(cfg, seed=1, mesh=mesh, chunk=5)
        rounds = sim.run_until_converged(HORIZON)
    else:
        sim = SweepSimulator(cfg, [1, 2], mesh=mesh, chunk=5, **lanes)
        rounds = sim.run_until_converged(HORIZON)
    metrics = {k: v.tolist() for k, v in sim.metrics().items()}
    return {"rounds": rounds, "tick": sim.tick, "metrics": metrics,
            "blocks": digests(sim.blocks)}


def main() -> None:
    address, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    multihost.initialize(address, world, rank, device="cpu")
    out = {"rank": rank, "primary": multihost.is_primary(),
           "processes": multihost.process_count()}
    for name in CASES:
        out[name] = run_case(name, lambda k: multihost.global_mesh(["cpu"] * k))
    sim = Simulator(CASES["kernels"][0], mesh=multihost.global_mesh(["cpu"]))
    try:
        sim.save("unused.npz")
    except RuntimeError as exc:
        out["save_refused"] = str(exc)
    print(json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
