"""The port's kernels against the Pallas kernels they replace.

On the CPU each kernel wrapper takes its plain torch version, which is
held here against the Pallas kernel run in interpret mode
(``repro.kernels.ops.*(interpret=True)``, as ``tests/test_kernels.py``
runs it).  ``tests/test_torch_cuda.py`` holds the CUDA kernels against
the plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bq as jbq
from repro.kernels import ops
from repro_torch.core import bq
from repro_torch.kernels import binarize as kb
from repro_torch.kernels import bq_distance as kd
from repro_torch.kernels import build, dispatch, list_scan

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)


def _vecs(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _table(seed, n, dim):
    """(n, 2W) reference words for seeded vectors, as uint32 and int32."""
    words = np.asarray(jbq.encode(jnp.asarray(_vecs(seed, n, dim))).words)
    return words, torch.from_numpy(words.copy().view(np.int32))


@pytest.mark.parametrize("dim", [64, 100, 384, 768, 1536])
@pytest.mark.parametrize("n", [4, 300])
def test_binarize_plain_matches_pallas(dim, n):
    x = _vecs(dim * 7 + n, n, dim)
    want = np.asarray(ops.binarize(jnp.asarray(x), interpret=True).words)
    got = kb.binarize(torch.from_numpy(x))
    assert got.dtype == torch.int32
    kb.strong_bit_flips(got.numpy(), want, x)


@pytest.mark.parametrize("dim", [64, 100, 768])
@pytest.mark.parametrize("b,k", [(1, 33), (5, 72), (3, 1), (2, 31),
                                 (4, 289)])
def test_dist_rows_plain_matches_pallas(dim, b, k):
    words, table = _table(dim + b, 300, dim)
    rng = np.random.default_rng(dim * b + k)
    q_rows = rng.integers(0, 300, size=b)
    ids = rng.integers(0, 300, size=(b, k)).astype(np.int32)
    dense = np.asarray(ops.bq_distance(words[q_rows], words, dim,
                                       interpret=True))  # -sim, (b, 300)
    got = kd.dist_rows(table[q_rows], torch.from_numpy(ids), table,
                       bq.valid_mask(dim))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), -np.take_along_axis(dense, ids, axis=1))


@pytest.mark.parametrize("dim", [64, 100, 768])
@pytest.mark.parametrize("c", [1, 8, 17, 40, 72, 128])
def test_pairwise_plain_matches_pallas(dim, c):
    words, table = _table(dim + c, 300, dim)
    ids = np.random.default_rng(c).integers(0, 300, size=(3, c)).astype(
        np.int32)
    got = kd.pairwise(torch.from_numpy(ids), table, bq.valid_mask(dim))
    for b in range(3):
        pool = words[ids[b]]
        want = -np.asarray(ops.bq_distance(pool, pool, dim, interpret=True))
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("dim", [100, 384])
def test_dispatch_matches_reference_ref_route(dim):
    from repro.kernels import dispatch as jdispatch

    words, table = _table(dim, 200, dim)
    ids = np.random.default_rng(dim).integers(0, 200, size=(4, 16)).astype(
        np.int32)
    jops = jdispatch.bq2_ops(dim, route="ref")
    ops_ = dispatch.bq2_ops(dim, "cpu")
    rows = jnp.asarray(words[ids])
    np.testing.assert_array_equal(
        ops_.dist_rows(table[:4], torch.from_numpy(ids), table).numpy(),
        np.asarray(jops.dist_rows(jnp.asarray(words[:4]), rows)))
    np.testing.assert_array_equal(
        ops_.pairwise(torch.from_numpy(ids), table).numpy(),
        np.asarray(jops.pairwise(rows)))


def test_cpu_route_launches_nothing():
    _, table = _table(0, 50, 100)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    build.reset_launches()
    kd.dist_rows(table[:2], ids, table, bq.valid_mask(100))
    kd.pairwise(ids, table, bq.valid_mask(100))
    kb.binarize(torch.zeros((2, 100)))
    list_scan.scan(table[:2], table[:7], bq.valid_mask(100))
    assert sum(build.LAUNCHES.values()) == 0


def test_wrappers_check_inputs():
    _, table = _table(1, 20, 100)
    mask = bq.valid_mask(100)
    with pytest.raises(ValueError, match="int32"):
        kd.dist_rows(table[:2], torch.zeros((2, 3), dtype=torch.int64),
                     table, mask)
    with pytest.raises(ValueError, match="q must be"):
        kd.dist_rows(table[:1], torch.zeros((2, 3), dtype=torch.int32),
                     table, mask)
    with pytest.raises(ValueError, match="table must be"):
        kd.pairwise(torch.zeros((2, 3), dtype=torch.int32), table[:, :4],
                    mask)
    with pytest.raises(ValueError, match="CUDA"):
        kb.binarize_cuda(torch.zeros((2, 100)))


def test_build_names_libraries_by_source_hash():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in ("binarize", "bq_distance", "list_scan"):
        out = build._target(name)
        assert out.parent == build.BUILD_DIR
        assert out.name.startswith(name + "-") and out.suffix == ".so"


def test_edited_header_renames_every_library(tmp_path, monkeypatch):
    """A library's name hashes the shared headers too: editing one rebuilds
    every kernel instead of loading a stale library."""
    for src in (*build.CSRC.glob("*.cu"), *build.CSRC.glob("*.cuh")):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "int8_levels.cuh").exists()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = ("binarize", "bq_distance", "list_scan")
    before = {name: build._target(name) for name in names}
    header = tmp_path / "int8_levels.cuh"
    header.write_text(header.read_text() + "\n")
    for name in names:
        assert build._target(name) != before[name]
