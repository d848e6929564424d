"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  The file imports torch and the port only (no jax), so that it
runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernels are built from ``src/repro_torch/csrc`` on first launch.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bq
from repro_torch.core.index import QuIVerIndex
from repro_torch.core.vamana import BuildParams
from repro_torch.data.datasets import make_dataset
from repro_torch.kernels import binarize as kb
from repro_torch.kernels import bq_distance as kd
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import hamming as kh
from repro_torch.kernels import list_scan as kl
from repro_torch.probe import probe_corpus

pytestmark = pytest.mark.cuda
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(n, dim, seed, device):
    g = torch.Generator().manual_seed(seed)
    return kb.binarize_plain(torch.randn((n, dim), generator=g)).to(device)


@pytest.mark.parametrize("dim", [100, 384, 768, 1536, 3072])
def test_binarize_matches_plain(cuda, dim):
    x = torch.randn((4099, dim),
                    generator=torch.Generator().manual_seed(dim)).to(cuda)
    build.reset_launches()
    got = kb.binarize(x)
    assert build.LAUNCHES["binarize"] == 1
    want = kb.binarize_plain(x)
    kb.strong_bit_flips(got.cpu().numpy(), want.cpu().numpy(),
                        x.cpu().numpy())
    # the plain version sums in the kernel's order: bit-identical
    assert torch.equal(got, want)


@pytest.mark.parametrize("dim", [384, 768, 1536])
@pytest.mark.parametrize("k", [72, 288])
def test_dist_rows_matches_plain(cuda, dim, k):
    table = _table(5000, dim, dim + k, cuda)
    g = torch.Generator().manual_seed(k)
    ids = torch.randint(0, 5000, (256, k), generator=g,
                        dtype=torch.int32).to(cuda)
    q = table[torch.randint(0, 5000, (256,), generator=g).to(cuda)]
    mask = bq.valid_mask(dim, device=cuda)
    build.reset_launches()
    got = kd.dist_rows(q, ids, table, mask)
    assert build.LAUNCHES["bq_dist_rows"] == 1
    assert torch.equal(got, kd.dist_rows_plain(q, ids, table, mask))


@pytest.mark.parametrize("dim", [384, 768, 1536, 3072])
@pytest.mark.parametrize("c", [72, 128])
def test_pairwise_matches_plain(cuda, dim, c):
    table = _table(5000, dim, dim + c, cuda)
    ids = torch.randint(0, 5000, (64, c),
                        generator=torch.Generator().manual_seed(c),
                        dtype=torch.int32).to(cuda)
    mask = bq.valid_mask(dim, device=cuda)
    build.reset_launches()
    got = kd.pairwise(ids, table, mask)
    assert build.LAUNCHES["bq_pairwise"] == 1
    assert torch.equal(got, kd.pairwise_plain(ids, table, mask))


@pytest.mark.parametrize("b,dup", [(1, True), (3, True), (256, True),
                                   (64, False)])
@pytest.mark.parametrize("dim", [64, 100, 768, 3072])
@pytest.mark.parametrize("c", [1, 15, 16, 17, 72, 100, 128, 129, 256, 512,
                               1024])
def test_pairwise_tiles_match_plain(cuda, c, dim, b, dup):
    # one diagonal tile with ragged strips (C <= 128), tile pairs off the
    # diagonal with their mirrors (C > 128: up to 36 a pool), 4-byte stores
    # where C is not a multiple of 4, and duplicate ids (dup: the second
    # half of each pool repeats the first; without it, a tile of the second
    # launch read or written in place of another shows)
    table = _table(5000, dim, dim + c + b, cuda)
    ids = torch.randint(0, 5000, (b, c),
                        generator=torch.Generator().manual_seed(c * 7 + b),
                        dtype=torch.int32)
    if dup:
        ids[:, c // 2:] = ids[:, :c - c // 2].clone()
    ids = ids.to(cuda)
    mask = bq.valid_mask(dim, device=cuda)
    build.reset_launches()
    got = kd.pairwise(ids, table, mask)
    assert build.LAUNCHES["bq_pairwise"] == 1
    assert build.LAUNCHES[f"bq_pairwise_c{c}"] == 1
    assert build.LAUNCHES["bq_pairwise_offdiag"] == (1 if c > 128 else 0)
    assert torch.equal(got, got.transpose(1, 2))
    assert torch.equal(got, kd.pairwise_plain(ids, table, mask))


@pytest.mark.parametrize("b", [1, 3, 256])
@pytest.mark.parametrize("k", [1, 31, 72, 288, 5256, 34_080])
@pytest.mark.parametrize("dim", [17, 64, 100, 768, 3072])
def test_dist_rows_gathers_match_plain(cuda, dim, k, b):
    # 4-byte words (W = 1, 2) and 16-byte vectors (W = 4, 24, 96: groups of
    # 1, 2 and 8 lanes), one row a group up to 8 rows a group (K = 34 080);
    # K = 5 256 = 72 + 72 * 72 is the streaming repair's candidate row
    table = _table(5000, dim, dim + k + b, cuda)
    g = torch.Generator().manual_seed(k * 3 + b)
    ids = torch.randint(0, 5000, (b, k), generator=g,
                        dtype=torch.int32).to(cuda)
    q = table[torch.randint(0, 5000, (b,), generator=g).to(cuda)]
    mask = bq.valid_mask(dim, device=cuda)
    build.reset_launches()
    got = kd.dist_rows(q, ids, table, mask)
    variant = ("bq_dist_rows_vec4" if mask.shape[0] % 4 == 0
               else "bq_dist_rows_word")
    assert build.LAUNCHES["bq_dist_rows"] == 1
    assert build.LAUNCHES[variant] == 1
    assert torch.equal(got, kd.dist_rows_plain(q, ids, table, mask))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", [1, 72])
@pytest.mark.parametrize("dim", [3104, 12_800])
def test_dist_rows_long_rows_match_plain(cuda, dim, k, b):
    # more than 96 words or vectors a plane (W = 97 in words, W = 400 in
    # 100 vectors): a 32-lane group reads the rest of the row in a loop
    table = _table(500, dim, dim + k + b, cuda)
    g = torch.Generator().manual_seed(k * 5 + b)
    ids = torch.randint(0, 500, (b, k), generator=g,
                        dtype=torch.int32).to(cuda)
    q = table[torch.randint(0, 500, (b,), generator=g).to(cuda)]
    mask = bq.valid_mask(dim, device=cuda)
    build.reset_launches()
    got = kd.dist_rows(q, ids, table, mask)
    assert build.LAUNCHES["bq_dist_rows"] == 1
    assert torch.equal(got, kd.dist_rows_plain(q, ids, table, mask))


def test_dist_rows_rejects_misaligned_vectors(cuda):
    table = _table(100, 768, 0, cuda)
    mask = bq.valid_mask(768, device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    q = torch.empty(2 * 48 + 1, dtype=torch.int32, device=cuda)[1:]
    q = q.view(2, 48).copy_(table[:2])
    with pytest.raises(ValueError, match="16-byte aligned"):
        kd.dist_rows(q, ids, table, mask)


@pytest.mark.parametrize("dim", [64, 100, 384, 768, 1536, 3072])
@pytest.mark.parametrize("n_lists", [45, 316, 1000])
@pytest.mark.parametrize("n_q", [1, 256, 8193])
def test_list_scan_matches_plain(cuda, dim, n_lists, n_q):
    # one query, both tile shapes (16 x 32 and 64 x 64), ragged edges, and
    # up to 96 k-chunks at D = 3072
    table = _table(n_q + n_lists, dim, dim + n_lists + n_q, cuda)
    q, cent = table[:n_q], table[n_q:]
    mask = bq.valid_mask(dim, device=cuda)
    build.reset_launches()
    got = kl.scan(q, cent, mask)
    assert build.LAUNCHES["list_scan"] == 1
    assert torch.equal(got, kl.scan_plain(q, cent, mask))


@pytest.mark.parametrize("b", [1, 3, 256])
@pytest.mark.parametrize("k", [1, 31, 72, 288, 777, 34_080])
@pytest.mark.parametrize("dim", [17, 64, 100, 384, 768, 1536, 3072])
def test_hamming_dist_rows_matches_plain(cuda, dim, k, b):
    # the sign plane in 4-byte words (W = 1, 2) and in 16-byte vectors
    # (W = 4, 12, 24, 48, 96: groups of 1, 1, 2, 4 and 8 lanes), one row a
    # group up to 8 rows a group (K = 34 080)
    table = _table(5000, dim, dim + k + b, cuda)
    g = torch.Generator().manual_seed(k * 3 + b)
    ids = torch.randint(0, 5000, (b, k), generator=g,
                        dtype=torch.int32).to(cuda)
    w = table.shape[1] // 2
    q = table[torch.randint(0, 5000, (b,), generator=g).to(cuda), :w]
    q = q.contiguous()
    build.reset_launches()
    got = kh.dist_rows(q, ids, table)
    assert build.LAUNCHES["hamming_dist_rows"] == 1
    assert build.LAUNCHES[f"hamming_dist_rows_vec{4 if w % 4 == 0 else 1}"] \
        == 1
    assert torch.equal(got, kh.dist_rows_plain(q, ids, table))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", [1, 72])
@pytest.mark.parametrize("dim", [3104, 12_800])
def test_hamming_dist_rows_long_rows_match_plain(cuda, dim, k, b):
    # more than 96 words or vectors of sign plane (W = 97 in words, W = 400
    # in 100 vectors): a 32-lane group reads the rest of the row in a loop
    table = _table(500, dim, dim + k + b, cuda)
    g = torch.Generator().manual_seed(k * 5 + b)
    ids = torch.randint(0, 500, (b, k), generator=g,
                        dtype=torch.int32).to(cuda)
    w = table.shape[1] // 2
    q = table[torch.randint(0, 500, (b,), generator=g).to(cuda), :w]
    q = q.contiguous()
    build.reset_launches()
    got = kh.dist_rows(q, ids, table)
    assert build.LAUNCHES["hamming_dist_rows"] == 1
    assert torch.equal(got, kh.dist_rows_plain(q, ids, table))


def test_hamming_dist_rows_rejects_misaligned_vectors(cuda):
    table = _table(100, 768, 0, cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    q = torch.empty(2 * 24 + 1, dtype=torch.int32, device=cuda)[1:]
    q = q.view(2, 24).copy_(table[:2, :24])
    with pytest.raises(ValueError, match="16-byte aligned"):
        kh.dist_rows(q, ids, table)


@pytest.mark.parametrize("b,dup", [(1, True), (3, True), (256, True),
                                   (64, False)])
@pytest.mark.parametrize("dim", [17, 64, 100, 768, 1536, 3072])
@pytest.mark.parametrize("c", [1, 15, 16, 17, 37, 72, 100, 128, 129, 256,
                               512, 1024])
def test_hamming_pairwise_matches_plain(cuda, c, dim, b, dup):
    # one tile (C <= 128: ragged m16n8 tiles, C not a multiple of 4) and
    # several (the off-diagonal launch); dup: each pool repeats its first
    # half, else its ids are drawn apart, so that a tile of the second
    # launch read or written in place of another shows
    table = _table(5000, dim, dim + c + b, cuda)
    ids = torch.randint(0, 5000, (b, c),
                        generator=torch.Generator().manual_seed(c * 7 + b),
                        dtype=torch.int32)
    if dup:
        ids[:, c // 2:] = ids[:, :c - c // 2].clone()
    ids = ids.to(cuda)
    mask = bq.valid_mask(dim, device=cuda)
    build.reset_launches()
    got = kh.pairwise(ids, table, mask)
    assert build.LAUNCHES["hamming_pairwise"] == 1
    assert build.LAUNCHES[f"hamming_pairwise_c{c}"] == 1
    assert build.LAUNCHES["hamming_pairwise_offdiag"] == (1 if c > 128
                                                          else 0)
    assert torch.equal(got, got.transpose(1, 2))
    assert torch.equal(got, kh.pairwise_plain(ids, table, mask))


@pytest.mark.parametrize("dim", [17, 100, 3071])
@pytest.mark.parametrize("c", [72, 256])
def test_hamming_pairwise_ignores_bits_outside_the_mask(cuda, dim, c):
    # set padding bits in the sign plane: the kernel decodes them to 0
    # under the mask, as the plain version masks them away
    table = _table(5000, dim, dim + c, cuda)
    mask = bq.valid_mask(dim, device=cuda)
    w = mask.shape[0]
    g = torch.Generator().manual_seed(dim + c)
    junk = torch.randint(-2 ** 31, 2 ** 31 - 1, (5000, w), generator=g,
                         dtype=torch.int32).to(cuda) & ~mask
    dirty = table.clone()
    dirty[:, :w] |= junk
    ids = torch.randint(0, 5000, (16, c), generator=g,
                        dtype=torch.int32).to(cuda)
    got = kh.pairwise(ids, dirty, mask)
    assert torch.equal(got, kh.pairwise(ids, table, mask))
    assert torch.equal(got, kh.pairwise_plain(ids, dirty, mask))


def test_card_bq1_build_equals_cpu_build(cuda):
    base, queries = make_dataset("minilm-surrogate", 1500, queries=50)
    params = BuildParams(m=8, ef_construction=48, prune_pool=48, chunk=128)
    build.reset_launches()
    gpu = QuIVerIndex.build(base, params, metric="bq1", device=cuda)
    g_ids, _ = gpu.search(queries, k=10, ef=64, rerank=False)
    assert build.LAUNCHES["hamming_dist_rows"] > 0
    assert build.LAUNCHES["hamming_pairwise"] > 0
    cpu = QuIVerIndex.build(base, params, metric="bq1", device="cpu")
    c_ids, _ = cpu.search(queries, k=10, ef=64, rerank=False)
    assert torch.equal(gpu.adjacency.cpu(), cpu.adjacency)
    assert gpu.medoid == cpu.medoid
    np.testing.assert_array_equal(g_ids, c_ids)


def test_card_probe_equals_cpu_probe(cuda):
    base, _ = make_dataset("glove-like", 3000, queries=0)
    build.reset_launches()
    gpu = probe_corpus(base, device=cuda)
    assert build.LAUNCHES["list_scan"] == 1
    cpu = probe_corpus(base, device="cpu")
    assert gpu.verdict == cpu.verdict
    assert gpu.bq_agreement == cpu.bq_agreement
    assert gpu.margin_p30 == cpu.margin_p30


def test_empty_batches_launch_cleanly(cuda):
    table = _table(10, 100, 0, cuda)
    mask = bq.valid_mask(100, device=cuda)
    ids = torch.zeros((0, 5), dtype=torch.int32, device=cuda)
    assert kd.dist_rows(table[:0], ids, table, mask).shape == (0, 5)
    assert kd.pairwise(ids, table, mask).shape == (0, 5, 5)
    assert kb.binarize(torch.zeros((0, 100), device=cuda)).shape == (0, 8)
    assert kl.scan(table[:0], table, mask).shape == (0, 10)
    assert kl.scan(table, table[:0], mask).shape == (10, 0)
    assert kh.dist_rows(table[:0, :4], ids, table).shape == (0, 5)
    assert kh.pairwise(ids, table, mask).shape == (0, 5, 5)


def test_card_build_equals_cpu_build(cuda):
    base, queries = make_dataset("minilm-surrogate", 1500, queries=50)
    params = BuildParams(m=8, ef_construction=48, prune_pool=48, chunk=128)
    build.reset_launches()
    gpu = QuIVerIndex.build(base, params, device=cuda)
    g_ids, _ = gpu.search(queries, k=10, ef=64, rerank=False)
    assert all(build.LAUNCHES[k] > 0
               for k in ("binarize", "bq_dist_rows", "bq_pairwise"))
    cpu = QuIVerIndex.build(base, params, device="cpu")
    c_ids, _ = cpu.search(queries, k=10, ef=64, rerank=False)
    assert torch.equal(gpu.sigs.words.cpu(), cpu.sigs.words)
    assert torch.equal(gpu.adjacency.cpu(), cpu.adjacency)
    assert gpu.medoid == cpu.medoid
    np.testing.assert_array_equal(g_ids, c_ids)


def test_card_ivf_build_equals_cpu_build(cuda):
    base, queries = make_dataset("cohere-surrogate", 1500, queries=50)
    params = BuildParams(m=6, ef_construction=32, prune_pool=32, chunk=128,
                         ivf_candidates=True)
    build.reset_launches()
    gpu = QuIVerIndex.build(base, params, device=cuda)
    g_ids, _ = gpu.search(queries, k=10, ef=128, nav="ivf", rerank=False)
    assert all(build.LAUNCHES[k] > 0 for k in (
        "binarize", "bq_dist_rows", "bq_pairwise", "list_scan"))
    cpu = QuIVerIndex.build(base, params, device="cpu")
    c_ids, _ = cpu.search(queries, k=10, ef=128, nav="ivf", rerank=False)
    for field in ("cent_words", "list_ids"):
        assert torch.equal(getattr(gpu.ivf, field).cpu(),
                           getattr(cpu.ivf, field)), field
    for field in ("cent_ids", "assign", "offsets", "member_ids"):
        np.testing.assert_array_equal(getattr(gpu.ivf, field),
                                      getattr(cpu.ivf, field), err_msg=field)
    assert torch.equal(gpu.adjacency.cpu(), cpu.adjacency)
    assert gpu.medoid == cpu.medoid
    np.testing.assert_array_equal(g_ids, c_ids)


def _stream_script(index, base, queries, member):
    """The streaming mutation script of ``chip_smoke.py``'s parity phase on
    ``index`` (labelled): adopt, insert 10% with labels, delete 7.5% (the
    medoid among them), a filtered search, consolidate, insert into the
    reclaimed slots, freeze.  Returns the mutable index, the frozen one and
    each search's hot-path ids."""
    from repro_torch.stream import MutableQuIVerIndex

    n = index.adjacency.shape[0]
    mut = MutableQuIVerIndex.from_index(index)
    ids = []

    def search(**kw):
        ids.append(mut.search(queries, k=10, ef=32, rerank=False, **kw)[0])

    extra = len(base) - n
    mut.insert(base[n:n + extra // 2],
               labels=[np.nonzero(m)[0].tolist() for m in member[n:]][
                   :extra // 2])
    dead = np.r_[mut.medoid, np.arange(0, 3 * n // 40)]
    mut.delete(dead)
    search()
    search(filter=0)
    search(filter=2)
    mut.consolidate()
    search()
    mut.insert(base[n + extra // 2:])
    search(filter=1)
    return mut, mut.freeze(), ids


def test_card_stream_script_equals_cpu(cuda, tmp_path):
    from repro_torch.stream import MutableQuIVerIndex

    base, queries = make_dataset("cohere-surrogate", 1650, queries=40)
    params = BuildParams(m=6, ef_construction=32, prune_pool=32, chunk=128)
    member = np.stack([np.random.default_rng(0).random(len(base)) < p
                       for p in (0.5, 0.2, 0.01)], axis=1)
    cpu = QuIVerIndex.build(base[:1500], params, device="cpu")
    from repro_torch import convert
    gpu = convert.index_from_numpy(convert.index_to_numpy(cpu), cuda)
    for index in (cpu, gpu):
        index.attach_labels([np.nonzero(m)[0].tolist()
                             for m in member[:1500]], n_labels=3)
    build.reset_launches()
    g_mut, g_frozen, g_ids = _stream_script(gpu, base, queries, member)
    assert all(build.LAUNCHES[k] > 0
               for k in ("binarize", "bq_dist_rows", "bq_pairwise"))
    c_mut, c_frozen, c_ids = _stream_script(cpu, base, queries, member)
    for name in ("words", "adjacency", "deg"):
        assert torch.equal(getattr(g_mut, name).cpu(),
                           getattr(c_mut, name)), name
    assert torch.equal(g_mut.labels.words.cpu(), c_mut.labels.words)
    np.testing.assert_array_equal(g_mut.live, c_mut.live)
    np.testing.assert_array_equal(g_mut.allocated, c_mut.allocated)
    assert g_mut._free == c_mut._free and g_mut.medoid == c_mut.medoid
    for g, c in zip(g_ids, c_ids):
        np.testing.assert_array_equal(g, c)
    assert torch.equal(g_frozen.adjacency.cpu(), c_frozen.adjacency)
    assert g_frozen.medoid == c_frozen.medoid
    # an archive saved on the card loads on the CPU
    g_mut.save(str(tmp_path / "stream.npz"))
    back = MutableQuIVerIndex.load(str(tmp_path / "stream.npz"), "cpu")
    assert torch.equal(back.adjacency, c_mut.adjacency)
    assert back.probe_acc == c_mut.probe_acc


@pytest.fixture(scope="module")
def labelled_pair():
    """One labelled IVF-seeded index on the CPU and the same index carried
    to the card, with per-label entries built on each device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import convert

    base, queries = make_dataset("cohere-surrogate", 1500, queries=40)
    params = BuildParams(m=6, ef_construction=32, prune_pool=32, chunk=128,
                         ivf_candidates=True)
    cpu = QuIVerIndex.build(base, params, device="cpu")
    gpu = convert.index_from_numpy(convert.index_to_numpy(cpu), "cuda")
    rng = np.random.default_rng(0)
    member = np.stack([rng.random(1500) < p for p in (0.5, 0.2, 0.01)],
                      axis=1)
    rows = [np.nonzero(m)[0].tolist() for m in member]
    for index in (cpu, gpu):
        index.attach_labels(rows, n_labels=3)
        index.build_label_entries(min_count=32)
    return {"cpu": cpu, "gpu": gpu, "queries": queries, "member": member}


def _ids_match(a, b, scores_a, scores_b, tol=1e-6):
    """Ids may differ at a rank only where the two scores there tie."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    diff = a != b
    assert (np.abs(scores_a[diff] - scores_b[diff]) <= tol).all()


@pytest.mark.parametrize("label,kw,route", [
    (0, {"rerank": False}, "graph"), (1, {}, "graph"),
    (2, {"rerank": False}, "brute"), (2, {}, "brute"),
    (1, {"nav": "ivf", "rerank": False}, "ivf"), (0, {"nav": "ivf"}, "ivf"),
    (0, {"nav": "bq1", "rerank": False}, "graph"),
], ids=lambda v: str(v) if not isinstance(v, dict) else "-".join(
    f"{k}{x}" for k, x in v.items()) or "rerank")
def test_card_filtered_plans_equal_cpu(labelled_pair, label, kw, route):
    import dataclasses

    from repro_torch.plan import resolve_plan

    cpu, gpu, q = (labelled_pair[k] for k in ("cpu", "gpu", "queries"))
    np.testing.assert_array_equal(gpu.labels.entries, cpu.labels.entries)
    c_plan, c_ctx = resolve_plan(cpu, k=10, ef=32, filter=label, **kw)
    g_plan, g_ctx = resolve_plan(gpu, k=10, ef=32, filter=label, **kw)
    assert dataclasses.asdict(g_plan) == dataclasses.asdict(c_plan)
    assert g_plan.route == route and g_ctx.start == c_ctx.start
    build.reset_launches()
    g_ids, g_scores = gpu.search(q, k=10, ef=32, filter=label, **kw)
    launched = dict(build.LAUNCHES)
    c_ids, c_scores = cpu.search(q, k=10, ef=32, filter=label, **kw)
    # the reranked brute route is one matmul over the match set
    want = set() if route == "brute" and g_plan.rerank else {
        "binarize",
        "hamming_dist_rows" if kw.get("nav") == "bq1" else "bq_dist_rows"}
    if route == "ivf":
        want.add("list_scan")
    assert {k for k in want if launched.get(k, 0) > 0} == want
    if g_plan.rerank:
        _ids_match(g_ids, c_ids, g_scores, c_scores)
    else:
        np.testing.assert_array_equal(g_ids, c_ids)
        np.testing.assert_array_equal(g_scores, c_scores)
    member = labelled_pair["member"][:, label]
    assert member[g_ids[g_ids >= 0]].all()


@pytest.mark.parametrize("which", ["result", "node", "both"])
@pytest.mark.parametrize("expand", [1, 4])
def test_card_masked_beam_equals_cpu(labelled_pair, which, expand):
    from repro_torch.core.beam import BeamResult, beam_search

    cpu, gpu = labelled_pair["cpu"], labelled_pair["gpu"]
    n = cpu.adjacency.shape[0]
    node = torch.from_numpy(np.random.default_rng(3).random(n) > 0.3)
    result = torch.from_numpy(labelled_pair["member"][:, 0])
    masks = {"result": {"result_valid": result},
             "node": {"node_valid": node},
             "both": {"node_valid": node, "result_valid": result}}[which]
    words = cpu.backend().encode_queries(
        torch.from_numpy(labelled_pair["queries"]))
    out = []
    for index in (cpu, gpu):
        dev = index.device
        out.append(beam_search(
            words.to(dev), index.adjacency, index.medoid,
            dist_fn=index.backend().dist_many, ef=48, n=n, expand=expand,
            **{k: v.to(dev) for k, v in masks.items()}))
    for field in BeamResult._fields:
        assert torch.equal(getattr(out[1], field).cpu(),
                           getattr(out[0], field)), field


# (b, tq, tk, h, kv heads, hd, causal, q_offset, kv_valid_len)
FLASH_CASES = {
    "ragged_causal": (2, 100, 100, 4, 4, 64, True, 0, 100),
    "ragged_bidirectional": (1, 77, 77, 2, 2, 32, False, 0, 77),
    "gqa": (2, 130, 130, 8, 2, 64, True, 0, 130),
    "prefill_longer_cache": (3, 70, 128, 4, 4, 64, True, 0, 70),
    "decode": (4, 1, 384, 8, 2, 64, True, 320, 321),
    "short_queries": (2, 5, 200, 4, 2, 16, True, 150, 155),
    "hd16": (2, 96, 96, 4, 2, 16, True, 0, 96),
    "hd128": (1, 65, 129, 4, 4, 128, True, 0, 129),
    # decode: kv_valid_len before, on and after a 64-key split boundary
    "decode_one_key": (2, 1, 128, 4, 4, 64, True, 0, 1),
    "decode_before_split": (2, 1, 128, 4, 4, 64, True, 62, 63),
    "decode_on_split": (2, 1, 128, 4, 4, 64, True, 63, 64),
    "decode_after_split": (2, 1, 128, 4, 4, 64, True, 64, 65),
    # q_offset 5 hides keys 6..199: splits 1..3 see no key
    "decode_masked_splits": (2, 1, 256, 8, 2, 64, True, 5, 200),
    "decode_long_cache": (1, 1, 4096, 8, 8, 64, True, 4095, 4096),
    "decode_gqa_group4": (3, 1, 256, 16, 4, 64, True, 200, 201),
    "decode_hd16": (2, 1, 200, 8, 4, 16, True, 150, 151),
    "decode_hd32": (2, 1, 200, 8, 4, 32, True, 150, 151),
    "decode_hd128": (2, 1, 200, 8, 4, 128, True, 150, 151),
    "decode_bidirectional": (2, 1, 150, 4, 2, 32, False, 0, 130),
    "prefill_offset_ragged": (2, 70, 256, 8, 4, 64, True, 100, 170),
    "embed_ragged": (4, 45, 45, 8, 8, 64, True, 0, 45),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_plain(cuda, case, dtype):
    """float32 within 2e-3 (the reference kernel's own tolerance), bf16
    within 2e-2 of the plain version on the same bf16 inputs."""
    b, tq, tk, h, kvh, hd, causal, q_offset, valid = FLASH_CASES[case]
    g = torch.Generator().manual_seed(len(case))
    q = torch.randn((b, tq, h, hd), generator=g).to(cuda, dtype)
    k = torch.randn((b, tk, kvh, hd), generator=g).to(cuda, dtype)
    v = torch.randn((b, tk, kvh, hd), generator=g).to(cuda, dtype)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid)
    build.reset_launches()
    got = kf.flash_attention(q, k, v, **kw)
    assert build.LAUNCHES["flash_attention"] == 1
    # one launch of the kernel the dtype and Tq select, none of the others
    variant = "fma" if dtype == torch.float32 else (
        "split_kv" if tq == 1 else "mma")
    assert {key: build.LAUNCHES[name] for key, name in kf.VARIANTS.items()} \
        == {key: int(key == variant) for key in kf.VARIANTS}
    want = kf.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    tol = dict(rtol=2e-3, atol=2e-3) if dtype == torch.float32 \
        else dict(rtol=0, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_flash_attention_reads_cache_slices_and_mixed_dtypes(cuda):
    """A layer's slice of a stacked bf16 cache, read through its strides,
    under float32 queries (float32 parameters over the bf16 cache)."""
    g = torch.Generator().manual_seed(3)
    cache = torch.randn((3, 2, 64, 2, 16), generator=g).to(cuda,
                                                           torch.bfloat16)
    q = torch.randn((2, 1, 4, 16), generator=g).to(cuda)
    got = kf.flash_attention(q, cache[1], cache[2], q_offset=40,
                             kv_valid_len=41)
    want = kf.flash_attention_plain(q, cache[1].contiguous(),
                                    cache[2].contiguous(), q_offset=40,
                                    kv_valid_len=41)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", sorted(c for c in FLASH_CASES
                                         if FLASH_CASES[c][1] == 1))
def test_flash_split_kv_matches_its_mirror(cuda, case):
    """The split-KV decode against the float32 mirror of its arithmetic
    (``flash_decode_split_plain``) on the same bf16 inputs, within 2e-2."""
    b, tq, tk, h, kvh, hd, causal, q_offset, valid = FLASH_CASES[case]
    g = torch.Generator().manual_seed(tk + valid)
    q = torch.randn((b, tq, h, hd), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((b, tk, kvh, hd), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((b, tk, kvh, hd), generator=g).to(cuda, torch.bfloat16)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid)
    got = kf.flash_attention(q, k, v, **kw)
    want = kf.flash_decode_split_plain(q, k, v, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("tq,q_offset", [(1, 200), (70, 130)])
def test_flash_attention_reads_bf16_cache_slices(cuda, tq, q_offset):
    """bf16 K/V through strides: a layer's slice of the stacked cache and
    the halves of a fused (B, S, 2, K, hd) buffer, in decode (split-KV)
    and prefill (tensor cores)."""
    g = torch.Generator().manual_seed(tq)
    stack = torch.randn((3, 2, 256, 2, 64), generator=g).to(cuda,
                                                            torch.bfloat16)
    fused = torch.randn((2, 256, 2, 2, 64), generator=g).to(cuda,
                                                            torch.bfloat16)
    q = torch.randn((2, tq, 8, 64), generator=g).to(cuda, torch.bfloat16)
    kw = dict(q_offset=q_offset, kv_valid_len=q_offset + tq)
    for k, v in ((stack[1], stack[2]), (fused[:, :, 0], fused[:, :, 1])):
        got = kf.flash_attention(q, k, v, **kw)
        want = kf.flash_attention_plain(q, k.contiguous(), v.contiguous(),
                                        **kw)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=2e-2)


def test_flash_attention_rejects_misaligned_bf16_rows(cuda):
    """The bf16 kernels copy 16-byte vectors: a K one element off its
    alignment, or a position stride that is not a multiple of 8, raises
    before any launch."""
    n = 2 * 64 * 2 * 64
    flat = torch.zeros(n + 1, device=cuda, dtype=torch.bfloat16)
    k = flat[1:].view(2, 64, 2, 64)
    q = torch.zeros((2, 1, 4, 64), device=cuda, dtype=torch.bfloat16)
    build.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        kf.flash_attention(q, k, k, q_offset=10, kv_valid_len=11)
    wide = torch.zeros((2, 64, 2 * 64 + 4), device=cuda,
                       dtype=torch.bfloat16)
    v = wide[:, :, :128].unflatten(2, (2, 64))
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        kf.flash_attention(q.expand(2, 5, 4, 64), v, v, q_offset=10,
                           kv_valid_len=15)
    assert sum(build.LAUNCHES.values()) == 0


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head width"):
        kf.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 2, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not instantiated"):
        kf.flash_attention(q, q.float(), q.float())


def test_card_minicpm_two_layers_matches_cpu(cuda):
    """minicpm-2b at full width and 2 layers, bf16, drawn on the CPU and
    copied to the card: prefill and 8 decode steps (fed the CPU's greedy
    tokens) within 0.1 in every logit, equal argmax where the CPU's top-2
    gap exceeds 0.2; mean-pooled embeddings at cosine >= 0.999."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serve.engine import mean_pool_embedder

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=2)
    bundle = build_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = DecoderLM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)

    def run(model, device, feed=None):
        caches = bundle.init_caches(2, 64, device=device)
        logits, caches = bundle.prefill(model, {"tokens": prompts}, caches)
        steps = [logits.float().cpu()]
        for i in range(8):
            tok = steps[-1].argmax(-1) if feed is None else feed[i]
            logits, caches = bundle.decode(model, tok[:, None], caches,
                                           48 + i)
            steps.append(logits.float().cpu())
        return steps

    want = run(cpu, "cpu")
    build.reset_launches()
    got = run(gpu, cuda, feed=[w.argmax(-1) for w in want[:-1]])
    assert build.LAUNCHES["flash_attention"] == 2 * 9
    for w, gt in zip(want, got):
        real = w > -1e29
        assert (gt - w).abs()[real].max() <= 0.1
        top2 = w.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 0.2
        assert torch.equal(gt.argmax(-1)[clear], w.argmax(-1)[clear])
    e_cpu = mean_pool_embedder(bundle, cpu)(prompts)
    e_gpu = mean_pool_embedder(bundle, gpu)(prompts).cpu()
    assert torch.nn.functional.cosine_similarity(e_cpu, e_gpu).min() >= 0.999
