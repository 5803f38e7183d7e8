"""One single-pass gossip sub-exchange, out of place: the wrapper of the
CUDA kernel (csrc/m8_pull.cu, the port of the reference's
ops/pallas_pull.py::_m8_kernel) and its plain PyTorch version.

The same sub-exchange as ops/pairs_pull.py (and the same bits: row ``i``
pulls from its partner ``p[i]`` under the per-exchange budget and
absorbs the partner's heartbeats, both computed from the pre-exchange
rows), served the way the reference's ``pallas_variant="m8"`` serves it:
the output rows are computed from the input rows into new tensors, and
the inputs are never written. Optional modes, as on the TPU: the
owner-diagonal refresh (``mv``/``hbv``, the round's first
sub-exchange), the rows' deficit totals given as an input (``totals``,
from ops/m8_totals.py: the two-pass form, which stages nothing and so
takes any width), and a column block of the owners (``owner_offset``,
the reference's sharded form, here a block of one device's matrix).

The kernel runs in the pairs pull's frame (csrc/pair_frame.cuh): one
group of CTAs a row pair reads both rows once and writes both output
rows. Without ``totals`` the pair is staged in shared memory by a
thread-block cluster of ``cluster`` CTAs (``pairs_pull.cluster_size``
picks it, as for the pairs pull); ``gossip.kernel_pull_form`` is the one
rule for the form a round takes ("m8", "m8_cluster", "m8_two_pass").

``arith`` selects the arithmetic of the reference's int16 experiment
(benchmarks/records/_i16_kernel_experiment.py): "i16" computes the
deficits and the heartbeat absorb in int16, "i16_f32" also feeds the
advance from int16 in float32. Both compute the same function as the
default "i32", so their plain version is this module's, and the kernel
takes them only in the experiment's mode (int16 w and hb, no refresh,
no totals). CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build, counters, gossip, prng
from .fd import MATRIX_DTYPES, expect
from .pairs_pull import cluster_fits, cluster_size

ARITH_CODES = {"i32": 0, "i16": 1, "i16_f32": 2}


def _check_modes(hb, mv, hbv, totals, arith) -> None:
    """The operand rules both versions share (the reference's)."""
    if arith not in ARITH_CODES:
        raise ValueError(f"unknown arith {arith!r} (one of {sorted(ARITH_CODES)})")
    if mv is not None and hb is not None and hbv is None:
        raise ValueError("hbv required when mv is given and hb is tracked")
    if hbv is not None and hb is None:
        raise ValueError("hbv given but no hb matrix to refresh (lean mode)")
    if hbv is not None and mv is None:
        raise ValueError("hbv given without mv: the diagonal refresh is all-or-none")
    if arith != "i32" and (hb is None or mv is not None or totals is not None):
        raise ValueError(f"arith={arith!r} runs only with hb, no refresh and no totals")


def _outputs(w, hb, out):
    """The output tensors: ``out`` = (w_out, hb_out), either entry None
    to allocate it; they must not overlap the inputs."""
    w_out, hb_out = (None, None) if out is None else out
    if hb is None and hb_out is not None:
        raise ValueError("hb_out given in lean mode")
    w_out = torch.empty_like(w) if w_out is None else w_out
    if hb is not None:
        hb_out = torch.empty_like(hb) if hb_out is None else hb_out
    for o in (w_out, hb_out):
        for x in (w, hb):
            if o is not None and x is not None and o.untyped_storage().data_ptr() == (
                x.untyped_storage().data_ptr()
            ):
                raise ValueError("m8_pull writes new tensors: out must not alias w or hb")
    return w_out, hb_out


def m8_pull_plain(
    w, hb, gm, c, valid, salt, run_salt, budget, *,
    mv=None, hbv=None, owner_offset: int = 0, totals=None, out=None, arith: str = "i32",
):
    """The plain version of ``m8_pull`` (same operands, same results). It
    runs over blocks of rows, each computed from the pre-exchange rows,
    so it runs at any width the kernel does."""
    _check_modes(hb, mv, hbv, totals, arith)
    w_out, hb_out = _outputs(w, hb, out)
    dev = w.device
    p = prng.rows_of_groups(gm.to(torch.int64), c.to(torch.int64))
    n_rows, n_cols = w.shape
    owners = owner_offset + torch.arange(n_cols, device=dev)
    for r0, r1 in gossip.row_blocks(n_rows, n_cols):
        rows = torch.arange(r0, r1, device=dev)
        partners = p[rows]
        v = valid[rows]
        x = gossip.refreshed_rows(w, rows, mv, col0=owner_offset)
        adv = gossip.budgeted_advance(
            x, gossip.refreshed_rows(w, partners, mv, col0=owner_offset), budget, v,
            salt, owners, run_salt, None if totals is None else totals[rows], rows,
        )
        w_out[r0:r1] = x + adv
        if hb is not None:
            h = gossip.refreshed_rows(hb, rows, hbv, col0=owner_offset)
            h_p = gossip.refreshed_rows(hb, partners, hbv, col0=owner_offset)
            hb_out[r0:r1] = torch.maximum(h, torch.where(v[:, None], h_p, 0))
    return w_out if hb is None else (w_out, hb_out)


def m8_pull(
    w, hb, gm, c, valid, salt, run_salt, budget, *,
    mv=None, hbv=None, owner_offset: int = 0, totals=None, out=None, arith: str = "i32",
    cluster: int | None = None,
):
    """One single-pass sub-exchange into new tensors: returns (w', hb'),
    or w' alone when ``hb`` is None (the lean profile).

    ``w`` (N, n_local) and ``hb`` (N, n_local) or None, each
    int8/int16/int32, the owners ``owner_offset .. owner_offset +
    n_local - 1`` (read only); ``gm``/``c`` (N/8,) int32 the grouped matching;
    ``valid`` (N,) bool the alive-pair mask per row; ``salt`` the
    sub-exchange salt and ``run_salt`` the run's; ``budget``
    key-versions per exchange. ``mv``/``hbv`` (n_local,) int32 refresh
    the owner diagonal first. ``totals`` (N,) float32, the rows' deficit
    totals over every owner (``m8_totals`` on the same operands, summed
    over the blocks), scales the advance instead of the kernel's own
    sums: no row is staged, so any width runs. Without ``totals``,
    ``cluster`` CTAs (1, 2, 4 or 8) stage each row pair; None takes
    ``pairs_pull.cluster_size``'s (the plain version has no clusters: the
    result is the same bits for every size). ``out`` = (w_out, hb_out)
    are written instead of new tensors (either may be None)."""
    if w.device.type == "cpu":
        counters.plain_calls["m8_pull"] += 1
        return m8_pull_plain(
            w, hb, gm, c, valid, salt, run_salt, budget, mv=mv, hbv=hbv,
            owner_offset=owner_offset, totals=totals, out=out, arith=arith,
        )
    _check_modes(hb, mv, hbv, totals, arith)
    (n, n_local), dev = w.shape, w.device
    if w.dtype not in MATRIX_DTYPES:
        raise ValueError(f"w dtype {w.dtype} is not int8/int16/int32")
    if n % 8:
        raise ValueError(f"m8 kernel needs N % 8 == 0, got N={n}")
    itemsize = w.element_size()
    if totals is not None:
        if n_local % 8:
            raise ValueError(f"m8 kernel needs n_local % 8 == 0, got {n_local}")
        expect("totals", totals, torch.float32, (n,), dev)
        if cluster not in (None, 1):
            raise ValueError("the totals-fed m8 pull stages nothing: it takes no cluster")
        cluster = 1
    else:
        # The pairs kernel's rule: the frame stages both rows' slices
        # beside the same static shared memory.
        if cluster is None:
            cluster = cluster_size(n_local, itemsize) or cluster_size(n_local, itemsize, 1)
        if cluster is None or not cluster_fits(n_local, itemsize, cluster):
            raise ValueError(
                f"m8 kernel cannot stage rows of {n_local} {w.dtype} watermarks on a "
                f"cluster of {cluster} (needs n_local % 8 == 0 and the slices of both "
                "rows in shared memory, a cluster of 1, 2, 4 or 8; pass totals for "
                "the two-pass form)"
            )
    expect("w", w, w.dtype, (n, n_local), dev)
    expect("gm", gm, torch.int32, (n // 8,), dev)
    expect("c", c, torch.int32, (n // 8,), dev)
    expect("valid", valid, torch.bool, (n,), dev)
    h_code = w.element_size()
    if hb is not None:
        if hb.dtype not in MATRIX_DTYPES:
            raise ValueError(f"hb dtype {hb.dtype} is not int8/int16/int32")
        expect("hb", hb, hb.dtype, (n, n_local), dev)
        h_code = hb.element_size()
    for name, vec in (("mv", mv), ("hbv", hbv)):
        if vec is not None:
            expect(name, vec, torch.int32, (n_local,), dev)
    w_out, hb_out = _outputs(w, hb, out)
    expect("w_out", w_out, w.dtype, (n, n_local), dev)
    if hb is not None:
        expect("hb_out", hb_out, hb.dtype, (n, n_local), dev)
    salt_mix = (int(salt) & prng.M32) ^ (int(run_salt) & prng.M32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load("m8_pull")
    rc = lib.aiocluster_m8_pull(
        w.data_ptr(), ptr(hb), w_out.data_ptr(), ptr(hb_out), gm.data_ptr(),
        c.data_ptr(), valid.data_ptr(), n, n_local, int(owner_offset), salt_mix,
        float(budget), ptr(totals), ptr(mv), ptr(hbv), w.element_size(), h_code,
        ARITH_CODES[arith], cluster, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "m8_pull kernel launch")
    counters.launches[counter_key(mv is not None, totals is not None, arith, cluster > 1)] += 1
    return w_out if hb is None else (w_out, hb_out)


def counter_key(
    diag: bool, totals: bool = False, arith: str = "i32", cluster: bool = False
) -> str:
    """The ``counters.launches`` key of a launch in this mode (``cluster``:
    staged by a cluster of more than one CTA)."""
    flags = [
        f for f, on in (
            ("cluster", cluster), ("totals", totals), ("diag", diag), (arith, arith != "i32"),
        )
        if on
    ]
    return f"m8_pull[{'+'.join(flags) or 'pull'}]"
