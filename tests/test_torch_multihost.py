"""A mesh across processes (parallel/multihost.py): two real processes
over gloo on the CPU, each holding its own column blocks of a 256-node
run, equal the single-process mesh of as many blocks bit for bit: every
block's every field, the converged rounds and the metrics, on the pairs
dispatch (the two-pass lane of the blocks: the totals gathered and
summed in block order), the greedy budget (exclusive offsets in block
order), the view draw (the best peer over the blocks in block order) and
a sweep; a save on such a mesh is refused with the reference's words.
The workers are subprocesses with one hard time limit for the pair: on
a timeout both are killed and the test fails. Blocks that hold part of
the owners are refused outside their mesh's collectives."""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aiocluster_torch import SimConfig
from aiocluster_torch.ops import gossip, prng
from aiocluster_torch.parallel import collectives, init_blocks, make_mesh
from aiocluster_torch.sim.checkpoint import ACROSS_PROCESSES

torch.set_num_threads(1)

_WORKER = Path(__file__).with_name("_torch_multihost_worker.py")
TIMEOUT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(_WORKER), f"127.0.0.1:{port}", "2", str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=str(_WORKER.parent.parent),
        )
        for rank in range(2)
    ]
    # Both ranks' pipes are drained at once, under one deadline for the pair.
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        talks = [pool.submit(p.communicate) for p in procs]
        done, _ = concurrent.futures.wait(talks, timeout=TIMEOUT_S)
        for p in procs:
            if p.poll() is None:
                p.kill()
        if len(done) < len(talks):
            pytest.fail(f"the 2-rank gloo run did not finish in {TIMEOUT_S} s")
        outs = []
        for p, talk in zip(procs, talks):
            out, err = talk.result()
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(json.loads(out.decode().splitlines()[-1]))
    return outs


def _worker():
    sys.path.insert(0, str(_WORKER.parent))
    import _torch_multihost_worker as worker

    return worker


@pytest.mark.parametrize("case", ["kernels", "greedy", "view", "sweep"])
def test_two_ranks_equal_the_single_process_mesh(ranks, case):
    worker = _worker()
    _, per_rank, _ = worker.CASES[case]
    want = worker.run_case(case, lambda k: make_mesh(["cpu"] * (2 * k)))
    got = [r[case] for r in ranks]
    for r in got:
        assert r["rounds"] == want["rounds"] and r["tick"] == want["tick"]
        assert r["metrics"] == want["metrics"]
    assert got[0]["blocks"] + got[1]["blocks"] == want["blocks"]
    assert len(got[0]["blocks"]) == per_rank


def test_the_ranks_report_their_world(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert [r["primary"] for r in ranks] == [True, False]
    assert all(r["processes"] == 2 for r in ranks)
    assert all(r["save_refused"] == ACROSS_PROCESSES for r in ranks)


def test_partial_blocks_outside_a_span_are_refused():
    """One process's share of a mesh (here 2 of 4 blocks) reduced outside
    its mesh's collectives would sum its own partials alone: refused."""
    cfg = SimConfig(n_nodes=256, keys_per_node=4, fanout=2, budget=40)
    mesh = make_mesh(["cpu"] * 4)
    blocks, offsets = init_blocks(cfg, mesh), mesh.offsets(cfg)
    key = prng.key(0)
    with pytest.raises(RuntimeError, match="128 of 256 owners"):
        gossip.step_blocks(blocks[:2], key, cfg, offsets=offsets[:2])
    with pytest.raises(RuntimeError, match="parallel.mesh.collectives"):
        gossip.metrics_sample_blocks(blocks[2:], offsets[2:])
    with collectives(mesh):  # the whole mesh in this process: no span needed
        gossip.step_blocks(blocks, key, cfg, offsets=offsets)
