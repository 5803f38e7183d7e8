"""What a run loads: no module whose top-level name (the part before the
first dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or
``aiocluster_tpu``; and the reference loads nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "aiocluster_tpu"}


def loaded_after(code: str) -> set[str]:
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, check=True,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_readers_and_a_cpu_run_load_no_jax():
    names = loaded_after(
        "from pathlib import Path\n"
        "from gossipbench import harness, control\n"
        "for p in sorted(Path('gossipbench').glob('*/*.py')):\n"
        "    if p.parent.name in ('metrics', 'e2e'): harness.load_module(p)\n"
        "cell = harness.load_cell('headline.sampled', overrides={'n_nodes': 128, 'budget': 40},\n"
        "                         traffic_overrides={'cap': 60, 'trace_rounds': 8})\n"
        "harness.run_cell(cell, 1, 0.1, True, 'cpu', trace_path=Path('build/gossipbench/imports.json'))\n")
    assert "aiocluster_torch" in names and "gossipbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "aiocluster_torch" != "aiocluster_tpu"


def test_reference_loads_nothing_of_the_port():
    names = loaded_after("import gossipbench.reference.sim, gossipbench.reference.bytes")
    assert "gossipbench" in names
    assert not names & (FORBIDDEN | {"aiocluster_torch"})


def test_forbidden_is_by_whole_top_level_name():
    from gossipbench import harness

    sys.modules.setdefault("aiocluster_tpu_like_name", type(sys)("aiocluster_tpu_like_name"))
    try:
        assert "aiocluster_tpu_like_name" not in harness.forbidden_modules()
        assert set(harness.FORBIDDEN) == FORBIDDEN
    finally:
        del sys.modules["aiocluster_tpu_like_name"]
