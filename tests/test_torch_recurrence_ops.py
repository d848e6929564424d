"""The recurrent cells as custom ops (``repro_torch.models.recurrence``),
on the CPU.

* Each op (``ssm_scan``, ``mlstm_chunkwise``, ``mlstm_sequential``,
  ``slstm_scan``) against its plain loop at small T, from zeros and from a
  given state: every output and every input's gradient equal bit for bit.
* ``tools/op_cost.py``'s counts of the op and its backward op (flops by
  bucket, bytes) equal its counts of the plain loop run in full, exactly:
  at 5 trips or fewer (the loop run at T itself on fake tensors) and past
  them (the fitted polynomial), for the forward alone, a training step
  (from zeros, the gradient through the main output only) and a step with
  a state that takes gradients through every output.
* Under a fake 16x16 process group each op's ``local_map`` region gives
  each rank's outputs the placements of ``models/mamba.py`` and
  ``models/xlstm.py``, and each input's gradient its placement (a
  ``Partial`` sum where a replicated input meets a split one).
* ``dist/cache_sharding.py`` lays the recurrent states of the full jamba
  and xlstm configs out as those regions read them (each state's
  ``LAYOUT``), the KV caches by the reference's rule.
* ``optim/compress.py``: the mesh form of the compressed all-reduce equals
  the one-controller form bit for bit on a world-1 CPU mesh, and under a
  fake 16x16 group its all-gathers carry numel / 4 + 8 bytes a member.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import get_config
from repro_torch.dist.cache_sharding import cache_shardings
from repro_torch.dist.sharding import AbstractMesh, use_mesh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import mamba, xlstm
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.optim import compress
from repro_torch.tools import collectives, op_cost

torch.set_num_threads(1)


def _ssm_inputs(rng, t, b=2, d=6, n=4):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    xs = [f(b, t, d), torch.from_numpy(rng.uniform(0.01, 0.5, (b, t, d))
                                      .astype(np.float32)),
          -torch.from_numpy(rng.uniform(0.5, 2, (d, n)).astype(np.float32)),
          f(b, t, n), f(b, t, n), f(d)]
    return xs, [f(b, d, n)]


def _mlstm_inputs(rng, t, b=2, h=2, dk=4, dv=6):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    xs = [f(b, h, t, dk), f(b, h, t, dk), f(b, h, t, dv), f(b, h, t),
          f(b, h, t) + 2]
    state = [f(b, h, dk, dv), f(b, h, dk).abs() + 0.5, f(b, h)]
    return xs, state


def _slstm_inputs(rng, t, b=2, h=2, hd=3):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    xs = [f(b, t, 4, h, hd), 0.3 * f(4, h, hd, hd)]
    state = [f(b, h, hd), f(b, h, hd).abs() + 0.5, f(b, h, hd), f(b, h, hd)]
    return xs, state


def _flat(out):
    main, state = out
    return [main, *state]


# name: (inputs, the op's entry point, its plain loop); each takes (xs,
# state or None) and returns the flat outputs
CASES = {
    "ssm_scan": (
        _ssm_inputs,
        lambda xs, st: _flat(mamba.ssm_scan(*xs, *(st or [None]))),
        lambda xs, st: _flat(mamba.ssm_scan_plain(*xs, *(st or [None])))),
    "mlstm_chunkwise": (
        _mlstm_inputs,
        lambda xs, st: _flat(xlstm.mlstm_chunkwise(*xs, chunk=4, state=st)),
        lambda xs, st: _flat(xlstm.mlstm_chunkwise_plain(*xs, chunk=4,
                                                         state=st))),
    "mlstm_sequential": (
        _mlstm_inputs,
        lambda xs, st: _flat(xlstm.mlstm_sequential(*xs, state=st)),
        lambda xs, st: _flat(xlstm.mlstm_sequential_plain(*xs, state=st))),
    "slstm_scan": (
        _slstm_inputs,
        lambda xs, st: _flat(xlstm.slstm_scan(*xs, st)),
        lambda xs, st: _flat(xlstm.slstm_scan_plain(*xs, st))),
}


def _run(fn, xs, state, *, grad: str | None, weights=None):
    """``fn`` over fresh leaves of ``xs`` (and ``state``); with ``grad``
    "main" the sum of the main output is differentiated, with "all" a
    weighted sum of every output.  Returns (outputs, input gradients)."""
    leaves = [x.clone().requires_grad_(grad is not None) for x in xs]
    st = None if state is None else [
        s.clone().requires_grad_(grad is not None) for s in state]
    outs = fn(leaves, st)
    grads = []
    if grad is not None:
        used = outs[:1] if grad == "main" else outs
        sum(((o * w).sum() for o, w in zip(used, weights)),
            torch.zeros(())).backward()
        grads = [x.grad for x in leaves + (st or [])]
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_equals_its_plain_loop_bit_for_bit(name, with_state):
    make, op, plain = CASES[name]
    rng = np.random.default_rng(0)
    xs, state = make(rng, 7)
    state = state if with_state else None
    want, _ = _run(plain, xs, state, grad=None)
    weights = [torch.from_numpy(rng.standard_normal(o.shape).astype(
        np.float32)) for o in want]
    mode = "all" if with_state else "main"
    got, got_g = _run(op, xs, state, grad=mode, weights=weights)
    want, want_g = _run(plain, xs, state, grad=mode, weights=weights)
    assert len(got) == len(want) and len(got_g) == len(want_g)
    for g, w in zip(got + got_g, want + want_g):
        assert w is not None and g.dtype == w.dtype
        assert torch.equal(g, w)


def _count(fn, xs, state, grad):
    with op_cost.OpCost() as mode:
        weights = None
        if grad is not None:
            weights = [torch.ones(()) for _ in range(8)]
        _run(fn, xs, state, grad=grad, weights=weights)
    return mode.result()


@pytest.mark.parametrize("config", ["forward", "train", "state"])
@pytest.mark.parametrize("t", [3, 30])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_cost_prices_the_op_as_its_plain_loop(name, t, config):
    """T = 3 runs 3 trips (1 for the chunkwise mLSTM, chunk 4); T = 30 runs
    30 (8 chunks, the last padded by 2): the fitted count."""
    make, op, plain = CASES[name]
    xs, state = make(np.random.default_rng(1), t)
    grad = {"forward": None, "train": "main", "state": "all"}[config]
    state = state if config == "state" else None
    got = _count(op, xs, state, grad)
    want = _count(plain, xs, state, grad)
    assert got == want
    assert want["by_prim"]["dot_general"] > 0
    assert want["by_prim"]["elementwise"] > 0


@pytest.fixture()
def fake_mesh():
    """A fake 256-rank process group and its 16x16 mesh, closed after."""
    mesh_mod.init_fake_world(256)
    yield mesh_mod.make_production_mesh(device_type="cpu")
    mesh_mod.close_mesh()


def _dt(x, mesh, *placements):
    return distribute_tensor(x, mesh, placements, src_data_rank=None) \
        .requires_grad_(True)


S0, R, P = Shard(0), Replicate(), Partial()


def test_region_placements_on_a_fake_16x16_mesh(fake_mesh):
    """Batch 16 on dp (16) and the split dims (mamba's d_inner, the
    mLSTM's dv) 32 over tp (16)."""
    rng = np.random.default_rng(2)
    mesh = fake_mesh
    # mamba: u, dt, a, d_skip split on d_inner; b_mat, c_mat whole on tp
    (u, dt, a, bm, cm, ds), (h0,) = _ssm_inputs(rng, 5, b=16, d=32)
    args = [_dt(u, mesh, S0, Shard(2)), _dt(dt, mesh, S0, Shard(2)),
            _dt(a, mesh, R, S0), _dt(bm, mesh, S0, R),
            _dt(cm, mesh, S0, R), _dt(ds, mesh, R, S0)]
    with use_mesh(mesh):
        y, h = mamba.ssm_scan(*args, h0=None)
        assert y.placements == (S0, Shard(2))
        assert h.placements == (S0, Shard(1))
        assert y.to_local().shape == (1, 5, 2)
        y.to_local().sum().backward()
    got = [x.grad.placements for x in args]
    assert got == [(S0, Shard(2)), (S0, Shard(2)), (P, S0), (S0, P),
                   (S0, P), (P, S0)]
    # the mLSTM: q, k, the gates, n and m whole on tp; v, C and h split
    xs, _ = _mlstm_inputs(rng, 6, b=16, h=2, dk=4, dv=32)
    args = [_dt(xs[0], mesh, S0, R), _dt(xs[1], mesh, S0, R),
            _dt(xs[2], mesh, S0, Shard(3)), _dt(xs[3], mesh, S0, R),
            _dt(xs[4], mesh, S0, R)]
    with use_mesh(mesh):
        out, state = xlstm.mlstm_chunkwise(*args, chunk=4)
        assert out.placements == (S0, Shard(3))
        assert [s.placements for s in state] == [(S0, Shard(3)), (S0, R),
                                                 (S0, R)]
        out.to_local().sum().backward()
    assert [x.grad.placements for x in args] == [
        (S0, P), (S0, P), (S0, Shard(3)), (S0, P), (S0, P)]
    # the sLSTM: whole on tp, the batch on dp; r's gradient summed over dp
    xs, _ = _slstm_inputs(rng, 3, b=16, h=2, hd=4)
    args = [_dt(xs[0], mesh, S0, R), _dt(xs[1], mesh, R, R)]
    with use_mesh(mesh):
        hs, state = xlstm.slstm_scan(*args)
        assert hs.placements == (S0, R)
        assert all(s.placements == (S0, R) for s in state)
        hs.to_local().sum().backward()
    assert [x.grad.placements for x in args] == [(S0, R), (P, R)]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_state_layouts_are_the_regions(arch):
    """decode_32k's caches (batch 128) on the 16x16 mesh: mamba's conv and
    ssm states with d_inner on tp, the mLSTM's C on its value dim, n, m and
    the sLSTM's states whole on tp; the batch on dp everywhere (where the
    reference's axis rule would leave mamba's states whole on tp and put
    C's key dim there)."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    caches = tf.init_caches(get_config(arch), 128, 32768, device="meta")
    specs = cache_shardings(mesh, caches, 128)
    want = {mamba.MambaState: (("data", None, "model"),
                               ("data", "model", None)),
            xlstm.MLSTMState: (("data", None, None, "model"),
                               ("data", None, None), ("data", None)),
            xlstm.SLSTMState: (("data", None, None),) * 4,
            # the reference's rule: jamba's 8 KV heads do not divide tp
            KVCache: (("data", None, None, None),) * 2}
    kinds = {type(c) for c in caches}
    assert kinds == ({mamba.MambaState, KVCache} if arch.startswith("jamba")
                     else {xlstm.MLSTMState, xlstm.SLSTMState})
    for cache, spec in zip(caches, specs):
        assert type(spec) is type(cache)
        assert tuple(spec) == want[type(cache)]


def test_compressed_psum_mesh_form_equals_the_plain_form():
    """World 1: the all-gathers return this rank's words and scalars, so
    the sum is the one-controller form's, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        1000).astype(np.float32))
    want = compress.compressed_psum([x])[0]
    mesh = mesh_mod.make_host_mesh("cpu")
    try:
        got = compress.compressed_psum_mesh(DTensor.from_local(
            x, mesh, (P,), run_check=False), mesh, "data")
        assert got.placements == (R,)
        assert torch.equal(got.to_local(), want)
    finally:
        mesh_mod.close_mesh()


def test_compressed_psum_wire_bytes(fake_mesh):
    """Each of the 16 members of the dp axis sends 2 bits an element (4 096
    elements: 128 int32 words) and two float32 scalars: every rank receives
    16 x (4 096 / 4 + 8) bytes in three all-gathers, the reference's count
    (``compression_ratio``)."""
    mesh = fake_mesh
    x = DTensor.from_local(torch.randn(4096), mesh, (P, R), run_check=False)
    with collectives.CollectiveCount() as cc:
        out = compress.compressed_psum_mesh(x, mesh, "data")
    assert out.placements == (R, R)
    got = cc.result()
    assert got["counts_by_kind"]["all-gather"] == 3
    assert got["total_bytes"] == 16 * (4096 / 4 + 8)
    ratio = compress.compression_ratio({"g": torch.zeros(4096)})
    assert 4 * 4096 / ratio == 4096 / 4 + 8
