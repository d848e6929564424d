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
    # the hybrid and vlm serving shapes: jamba's 32 heads over 8 and
    # internvl2's 16 over 8 at head_dim 128
    "jamba_embed": (64, 64, 64, 32, 8, 128, True, 0, 64),
    "jamba_prefill": (8, 320, 384, 32, 8, 128, True, 0, 320),
    "jamba_decode": (8, 1, 384, 32, 8, 128, True, 351, 352),
    "internvl2_prefill": (8, 320, 384, 16, 8, 128, True, 0, 320),
    "internvl2_decode": (8, 1, 384, 16, 8, 128, True, 351, 352),
    # the encdec serving shapes at head_dim 64, 16 heads over 16: whisper's
    # encoder over 1 500 frames and its cross-attention over them (prefill
    # 64 tokens, decode one) without a causal mask; a ragged Tq and Tk
    # without one
    "whisper_encoder": (8, 1500, 1500, 16, 16, 64, False, 0, 1500),
    "whisper_cross_prefill": (8, 64, 1500, 16, 16, 64, False, 0, 1500),
    "whisper_cross_decode": (8, 1, 1500, 16, 16, 64, False, 0, 1500),
    "whisper_self_decode": (8, 1, 96, 16, 16, 64, True, 95, 96),
    "ragged_noncausal": (2, 70, 130, 8, 4, 64, False, 0, 130),
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


# -- the MoE layer and a full-width MoE decoder, card against CPU -----------


def test_moe_dispatch_on_card_equals_cpu(cuda):
    """The capacity dispatch (stable sorts, ranks, drops, slots) of one set
    of expert ids on the card and on the CPU: identical, with drops."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(0)
    for b, t, e, k in ((2, 320, 60, 4), (8, 1, 60, 4), (3, 64, 8, 2),
                       (2, 48, 128, 8)):
        # a skewed draw: low expert ids far more often, so long rows drop
        idx = torch.multinomial(torch.linspace(4.0, 1.0, e).expand(b * t, e),
                                k, generator=g).reshape(b, t, k)
        cap = moe.capacity(t, e, k)
        want = moe.dispatch(idx, e, cap)
        got = moe.dispatch(idx.to(cuda), e, cap)
        for name, w, x in zip(want._fields, want, got):
            assert torch.equal(w, x.cpu()), (b, t, e, k, name)
        if t >= 64:
            assert not want.keep.all()


@pytest.mark.parametrize("shared", [0, 4])
def test_moe_layer_card_matches_cpu(cuda, shared):
    """One MoE layer (60 experts top-4, qwen2's counts) in float32 on the
    card against the CPU: identical routes at these inputs, outputs within
    1e-4, aux within 1e-6."""
    from repro_torch.models import moe

    cpu = moe.init_moe(moe.MoE(64, 96, 60, n_shared_experts=shared,
                               device="cpu", dtype=torch.float32),
                       generator=torch.Generator().manual_seed(0))
    gpu = moe.MoE(64, 96, 60, n_shared_experts=shared, device=cuda,
                  dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((3, 200, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, aux_w = moe.moe(cpu, x, top_k=4)
        got, aux_g = moe.moe(gpu, x.to(cuda), top_k=4)
        r_w = moe.route(cpu, x, top_k=4)
        r_g = moe.route(gpu, x.to(cuda), top_k=4)
    assert torch.equal(r_w.expert_idx, r_g.expert_idx.cpu())
    assert (got.cpu() - want).abs().max() <= 1e-4
    for key in aux_w:
        assert abs(aux_w[key].item() - aux_g[key].item()) <= 1e-6, key


def test_card_qwen2_moe_one_layer_matches_cpu(cuda):
    """qwen2-moe-a2.7b at full width and 1 layer, bf16, drawn on the CPU
    and copied to the card: prefill and 8 decode steps (the card fed the
    CPU's greedy tokens).  At least 0.98 of the (token, layer) top-4 sets
    equal; where a row's routes all agree, every logit within 0.1 and equal
    argmax where the CPU's top-2 gap exceeds 0.2."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import DecoderLM

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=1)
    bundle = build_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = DecoderLM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)
    route = moe.route

    def run(model, device, feed=None):
        seen = []

        def tap(*args, **kwargs):
            r = route(*args, **kwargs)
            seen.append(r.expert_idx.cpu())
            return r

        moe.route = tap
        try:
            caches = bundle.init_caches(2, 64, device=device)
            logits, caches = bundle.prefill(model, {"tokens": prompts},
                                            caches)
            steps = [logits.float().cpu()]
            for i in range(8):
                tok = steps[-1].argmax(-1) if feed is None else feed[i]
                logits, caches = bundle.decode(model, tok[:, None], caches,
                                               48 + i)
                steps.append(logits.float().cpu())
        finally:
            moe.route = route
        return steps, seen

    want, r_cpu = run(cpu, "cpu")
    build.reset_launches()
    got, r_gpu = run(gpu, cuda, feed=[w.argmax(-1) for w in want[:-1]])
    assert build.LAUNCHES["flash_attention"] == 9
    same = [(a.sort(-1).values == b.sort(-1).values).all(-1)
            for a, b in zip(r_cpu, r_gpu)]
    assert sum(int(m.sum()) for m in same) \
        >= 0.98 * sum(m.numel() for m in same)
    for w, gt, m in zip(want, got, same):
        agree = m.all(dim=1)
        real = w > -1e29
        diff = (gt - w).abs().masked_fill(~real, 0.0).amax(dim=1)
        assert (diff[agree] <= 0.1).all()
        top2 = w.topk(2, dim=-1).values
        clear = agree & (top2[:, 0] - top2[:, 1] > 0.2)
        assert torch.equal(gt.argmax(-1)[clear], w.argmax(-1)[clear])


# -- the hybrid and vlm families, card against CPU ---------------------------


def test_card_mamba_layer_matches_cpu(cuda):
    """One jamba mamba layer at full width (d 4096, d_inner 8192), bf16,
    drawn on the CPU and copied to the card: a prefill of 2 x 64 then 8
    one-token steps with both states carried; every output, and both
    states after the last step, within 2^-5 of its largest |value| (four
    bf16 ulps of it: bf16 products round at other places)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import mamba

    cfg = get_config("jamba-v0.1-52b")
    layers = {dev: mamba.Mamba(cfg.d_model, d_state=cfg.d_state,
                               device=dev) for dev in ("cpu", "cuda")}
    mamba.init_mamba(layers["cpu"], generator=torch.Generator().manual_seed(0))
    layers["cuda"].load_state_dict(layers["cpu"].state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 72, cfg.d_model)).astype(np.float32)).bfloat16()
    runs = {}
    with torch.no_grad():
        for dev, layer in layers.items():
            outs, conv, ssm = [], None, None
            for lo, hi in [(0, 64)] + [(i, i + 1) for i in range(64, 72)]:
                out, (conv, ssm) = mamba.mamba(layer, x[:, lo:hi].to(dev),
                                               conv, ssm)
                outs.append(out.float().cpu())
            runs[dev] = outs + [conv.float().cpu(), ssm.cpu()]
    for want, got in zip(runs["cpu"], runs["cuda"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2 ** -5 * want.abs().max()


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_card_xlstm_layer_matches_cpu(cuda, kind):
    """One ``xlstm-1.3b`` cell at full width (d 2 048, 4 heads; the mLSTM's
    d_inner 4 096, head blocks of 1 024), bf16, drawn on the CPU and copied
    to the card: a prefill of 2 x 64 from zeros, then 8 one-token steps
    with the state carried; every output, and each float32 state after the
    last step, within 2^-5 of its largest |value| (four bf16 ulps of it:
    bf16 products round at other places)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import xlstm

    cfg = get_config("xlstm-1.3b")
    if kind == "mlstm":
        cls, init, block = xlstm.MLSTM, xlstm.init_mlstm, xlstm.mlstm_block
    else:
        cls, init, block = xlstm.SLSTM, xlstm.init_slstm, xlstm.slstm_block
    cells = {dev: cls(cfg.d_model, n_heads=cfg.n_heads, device=dev)
             for dev in ("cpu", "cuda")}
    init(cells["cpu"], generator=torch.Generator().manual_seed(0))
    cells["cuda"].load_state_dict(cells["cpu"].state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 72, cfg.d_model)).astype(np.float32)).bfloat16()
    runs = {}
    with torch.no_grad():
        for dev, cell in cells.items():
            outs, state = [], None
            for lo, hi in [(0, 64)] + [(i, i + 1) for i in range(64, 72)]:
                out, state = block(cell, x[:, lo:hi].to(dev),
                                   n_heads=cfg.n_heads, state=state)
                outs.append(out.float().cpu())
            runs[dev] = outs + [s.cpu() for s in state]
    for want, got in zip(runs["cpu"], runs["cuda"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2 ** -5 * want.abs().max()


def test_card_jamba_smoke_matches_cpu(cuda):
    """``jamba-v0.1-52b.smoke()`` in float32, drawn on the CPU and copied to
    the card: prefill and 8 decode steps (the card fed the CPU's greedy
    tokens), every logit within 1e-3 and the same argmax; the mamba states
    and attention caches carried on the card as on the CPU; flash 2 x 9."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import DecoderLM

    cfg = get_config("jamba-v0.1-52b").smoke()
    bundle = build_model(cfg)
    cpu = bundle.init(0, device="cpu", dtype=torch.float32)
    gpu = DecoderLM(cfg, device=cuda, dtype=torch.float32)
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
        assert (gt - w).abs()[real].max() <= 1e-3
        assert torch.equal(gt.argmax(-1), w.argmax(-1))


def test_card_internvl2_two_layers_matches_cpu(cuda):
    """internvl2-2b at full width and 2 layers, bf16, 256 seeded patches
    before 48 tokens: prefill and 8 decode steps from position 304, every
    logit within 0.1 and equal argmax where the CPU's top-2 gap exceeds
    0.2; the loss's token count 2 x 48 on both devices."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import DecoderLM

    cfg = dataclasses.replace(get_config("internvl2-2b"), n_layers=2)
    bundle = build_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = DecoderLM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    patches = torch.from_numpy(rng.standard_normal(
        (2, 256, cfg.d_model)).astype(np.float32)).bfloat16()

    def run(model, device, feed=None):
        batch = {"tokens": prompts, "patches": patches.to(device)}
        caches = bundle.init_caches(2, 320, device=device)
        logits, caches = bundle.prefill(model, batch, caches)
        steps = [logits.float().cpu()]
        for i in range(8):
            tok = steps[-1].argmax(-1) if feed is None else feed[i]
            logits, caches = bundle.decode(model, tok[:, None], caches,
                                           304 + i)
            steps.append(logits.float().cpu())
        with torch.no_grad():
            _, metrics = bundle.loss(model, {**batch, "labels": prompts})
        return steps, float(metrics["tokens"])

    want, n_cpu = run(cpu, "cpu")
    got, n_gpu = run(gpu, cuda, feed=[w.argmax(-1) for w in want[:-1]])
    assert n_cpu == n_gpu == 96
    for w, gt in zip(want, got):
        real = w > -1e29
        assert (gt - w).abs()[real].max() <= 0.1
        top2 = w.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 0.2
        assert torch.equal(gt.argmax(-1)[clear], w.argmax(-1)[clear])


# -- the serving engine and the graph X-ray, card against CPU ----------------


class _StepClock:
    """A scripted clock: each read returns the time, then adds ``step``."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        now = self.t
        self.t += self.step
        return now


def _serve(index, queries):
    """One request script (three tenants, a quota, deadlines that degrade
    and drop under the scripted clock) through a ``QueryEngine``; returns
    every ticket's fields and results."""
    from repro_torch.obs import MetricsRegistry, ObsHub
    from repro_torch.serve.engine import QueryEngine

    clock = _StepClock(0.002)
    eng = QueryEngine(index, default_k=10, default_ef=32, clock=clock,
                      obs=ObsHub(MetricsRegistry()), shadow={"rate": 4})
    eng.set_quota("capped", qps=20.0, burst=3)
    ts = []
    for w in range(4):
        for i in range(6):
            row = 6 * w + i
            if i % 3 == 0:
                ts.append(eng.submit(queries[row], tenant="rag"))
            elif i % 3 == 1:
                ts.append(eng.submit(queries[row:row + 3], tenant="batch",
                                     deadline_ms=11 if w % 2 else None))
            else:
                ts.append(eng.submit(queries[row], tenant="capped"))
        if w == 3:
            clock.t += 0.5
        eng.pump()
    out = []
    for t in ts:
        tk = eng.ticket(t)
        ids, scores = eng.poll(t)
        out.append((tk.status, tk.degraded, tk.latency,
                    tk.plan.signature() if tk.plan else None, ids, scores))
    return out, eng.shadow.report()["drained"], list(
        eng.shadow.recalls.array())


def test_card_engine_equals_cpu(cuda):
    from repro_torch import convert

    base, queries = make_dataset("cohere-surrogate", 1500, queries=40)
    params = BuildParams(m=6, ef_construction=32, prune_pool=32, chunk=128)
    cpu = QuIVerIndex.build(base, params, device="cpu")
    gpu = convert.index_from_numpy(convert.index_to_numpy(cpu), cuda)
    build.reset_launches()
    got, g_drained, g_recalls = _serve(gpu, queries)
    assert build.LAUNCHES["binarize"] > 0
    assert build.LAUNCHES["bq_dist_rows"] > 0
    want, c_drained, c_recalls = _serve(cpu, queries)
    statuses = set()
    for g, c in zip(got, want):
        assert g[:4] == c[:4]
        np.testing.assert_array_equal(g[4], c[4])
        np.testing.assert_allclose(g[5], c[5], rtol=0, atol=1e-6)
        statuses.add(g[0])
    assert statuses == {"done", "rejected", "dropped"}
    assert g_drained == c_drained > 0 and g_recalls == c_recalls


@pytest.mark.parametrize("mutated", [False, True])
def test_card_graph_report_equals_cpu(cuda, mutated):
    from repro_torch import convert
    from repro_torch.obs import MetricsRegistry
    from repro_torch.stream import MutableQuIVerIndex

    base, _ = make_dataset("cohere-surrogate", 1500, queries=4)
    params = BuildParams(m=8, ef_construction=48, prune_pool=48, chunk=128)
    cpu = QuIVerIndex.build(base, params, device="cpu")
    gpu = convert.index_from_numpy(convert.index_to_numpy(cpu), cuda)
    if mutated:
        dead = np.random.default_rng(4).choice(1500, 200, replace=False)
        cpu, gpu = (MutableQuIVerIndex.from_index(i) for i in (cpu, gpu))
        for m in (cpu, gpu):
            m.delete(dead)
    build.reset_launches()
    g = gpu.graph_report(sample=64, registry=MetricsRegistry())
    # one bq_dist_rows launch: the agreement probe's (S, R) gather
    assert build.LAUNCHES["bq_dist_rows"] == 1
    c = cpu.graph_report(sample=64, registry=MetricsRegistry())
    gd, cd = g.to_dict(), c.to_dict()
    tol = 2 / (c.n_sampled * c.agreement_k)
    assert abs(gd.pop("edge_agreement") - cd.pop("edge_agreement")) <= tol
    gd.pop("health_score"), cd.pop("health_score")
    assert gd == cd and g.n_sampled == 64


def _same_fleet(g, c):
    """Two fleets' fields identical; the cold vectors, normalized on
    each device, within 1e-6."""
    assert g.keys() == c.keys()
    for name in g:
        if name == "vectors":
            np.testing.assert_allclose(g[name], c[name], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)


def _fleet_labels(n):
    return list(np.random.default_rng(0).integers(0, 2, n))


@pytest.mark.parametrize("placement", ["card", "mixed"])
def test_card_fleet_equals_cpu(cuda, placement):
    """``build_sharded`` and the fan-out on the card (or shards 1 and 3 on
    the card, 0 and 2 on the CPU) against the same fleet on the CPU."""
    from repro_torch import convert
    from repro_torch.core import distributed as dist

    base, queries = make_dataset("cohere-surrogate", 2003, queries=40)
    params = BuildParams(m=6, ef_construction=32, prune_pool=32, chunk=128)
    device = cuda if placement == "card" else ["cpu", cuda, "cpu", cuda]
    build.reset_launches()
    gpu = dist.build_sharded(base, 4, params, labels=_fleet_labels(2003),
                             label_entry_min=16, device=device)
    assert all(build.LAUNCHES[k] > 0
               for k in ("binarize", "bq_dist_rows", "bq_pairwise"))
    cpu = dist.build_sharded(base, 4, params, labels=_fleet_labels(2003),
                             label_entry_min=16, device="cpu")
    _same_fleet(convert.sharded_to_numpy(gpu), convert.sharded_to_numpy(cpu))
    for kw in ({}, {"filter": 1}, {"nav": "bq1"}):
        g_ids, g_scores = dist.search_sharded(gpu, queries, k=10, ef=48,
                                              **kw)
        c_ids, c_scores = dist.search_sharded(cpu, queries, k=10, ef=48,
                                              **kw)
        _ids_match(g_ids, c_ids, g_scores, c_scores)
        assert (g_ids < 2003).all()


def test_card_ivf_fleet_equals_cpu(cuda):
    from repro_torch.core import distributed as dist
    from repro_torch.obs import MetricsRegistry

    base, queries = make_dataset("cohere-surrogate", 2003, queries=40)
    gpu = dist.build_ivf_sharded(base, 4, seed=0, device=cuda)
    cpu = dist.build_ivf_sharded(base, 4, seed=0, device="cpu")
    np.testing.assert_array_equal(gpu.list_shard, cpu.list_shard)
    np.testing.assert_array_equal(gpu.list_local, cpu.list_local)
    for gs, cs in zip(gpu.shards, cpu.shards):
        np.testing.assert_array_equal(gs.ids, cs.ids)
        assert torch.equal(gs.sig_words.cpu(), cs.sig_words)
        assert torch.equal(gs.list_ids.cpu(), cs.list_ids)
    for broadcast in (False, True):
        build.reset_launches()
        g_ids, g_scores = dist.search_ivf_sharded(
            gpu, queries, broadcast=broadcast, registry=MetricsRegistry())
        assert build.LAUNCHES["list_scan"] > 0
        assert build.LAUNCHES["bq_dist_rows"] > 0
        c_ids, c_scores = dist.search_ivf_sharded(
            cpu, queries, broadcast=broadcast, registry=MetricsRegistry())
        _ids_match(g_ids, c_ids, g_scores, c_scores)


def test_card_streaming_fleet_equals_cpu(cuda):
    from repro_torch import convert
    from repro_torch.obs import MetricsRegistry
    from repro_torch.stream import StreamingShardedIndex

    base, queries = make_dataset("cohere-surrogate", 1400, queries=40)
    params = BuildParams(m=6, ef_construction=32, prune_pool=32, chunk=128)
    out = []
    for dev in (cuda, "cpu"):
        fleet = StreamingShardedIndex.empty(
            base.shape[1], n_shards=3, capacity_per_shard=500,
            params=params, device=dev)
        gids = fleet.insert(base[:1200])
        fleet.delete(np.concatenate([gids[:149], [fleet.shards[1].medoid
                                                  + 500]]))
        fleet.consolidate()
        fleet.insert(base[1200:1300])
        fan = fleet.search(queries, k=10, ef=48)
        fleet.enable_ivf_routing(seed=0)
        scatter = fleet.search(queries, k=10, ef=48, scatter=True,
                               registry=MetricsRegistry())
        out.append((fleet, fan, scatter))
    (g, g_fan, g_sc), (c, c_fan, c_sc) = out
    _same_fleet(*(convert.sharded_to_numpy(f.snapshot()) for f in (g, c)))
    for (gi, gsc), (ci, csc) in ((g_fan, c_fan), (g_sc, c_sc)):
        _ids_match(gi, ci, gsc, csc)


# -- the flash-attention backward and training, card against CPU ----------

# (b, tq, tk, h, kv heads, hd, causal, q_offset, kv_valid_len)
BWD_CASES = {
    "train_shape": (4, 256, 256, 36, 36, 64, True, 0, 256),
    "gqa_hd128": (1, 100, 100, 56, 8, 128, True, 0, 100),
    "hd16": (2, 70, 70, 4, 4, 16, True, 0, 70),
    "hd32_bidirectional": (2, 100, 100, 8, 2, 32, False, 0, 100),
    "offset_ragged": (2, 65, 130, 4, 2, 64, True, 50, 115),
    "hd128_offset": (1, 37, 100, 4, 2, 128, True, 20, 57),
    "masked_keys_bidirectional": (1, 45, 45, 8, 2, 64, False, 0, 40),
    "long_cache": (1, 128, 4096, 4, 4, 64, True, 3968, 4096),
    # one query row: its forward is the split-KV decode, so the bf16
    # backward gets the log-sum-exp from the tensor-core forward
    "one_row": (2, 1, 90, 4, 2, 32, True, 60, 63),
}
# the bf16 backward against its mirror, element by element: |got - want| <=
# 2^-7 |want| + 2^-9 max|want|.  The two round the same float32 values to
# bf16 at the same places, reached by float32 sums in another order, so an
# output may land one bf16 ulp (at most 2^-7 of itself) away; a rounding of
# P or dS that the order or exp2's last bit flips moves a gradient by a
# small share of the largest.
MIRROR_RTOL, MIRROR_ATOL = 2.0 ** -7, 2.0 ** -9


def _bwd_inputs(case, dtype, device):
    b, tq, tk, h, kvh, hd = BWD_CASES[case][:6]
    g = torch.Generator().manual_seed(tk + h)
    q, do = (torch.randn((b, tq, h, hd), generator=g).to(device, dtype)
             for _ in range(2))
    k, v = (torch.randn((b, tk, kvh, hd), generator=g).to(device, dtype)
            for _ in range(2))
    return q, k, v, do


def _close_to_mirror(got, want):
    w = want.float()
    torch.testing.assert_close(
        got.float(), w, rtol=MIRROR_RTOL,
        atol=MIRROR_ATOL * max(float(w.abs().max()), 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_matches_plain(cuda, case, dtype):
    """The backward kernel of ``dtype``'s route (bf16: tensor cores, given
    the forward's log-sum-exp; float32: CUDA cores) against
    ``flash_attention_backward_plain`` on the same inputs and forward
    output: float32 within 1e-4 of the largest gradient (float32 sums in
    another order, CUDA's expf), bf16 within one bf16 rounding of it
    (2^-7); bf16 also against its mirror ``flash_attention_backward_
    mma_plain`` (``MIRROR_RTOL``, ``MIRROR_ATOL``).  A second call (bf16
    without the log-sum-exp) equal bit for bit; dK and dV of the keys no
    row sees exactly zero."""
    causal, q_offset, valid = BWD_CASES[case][6:]
    tq = BWD_CASES[case][1]
    q, k, v, do = _bwd_inputs(case, dtype, cuda)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid)
    route = "mma" if dtype == torch.bfloat16 else "fma"
    if route == "mma":
        out, lse = kf.flash_attention_lse(q, k, v, **kw)
    else:
        out, lse = kf.flash_attention(q, k, v, **kw), None
    build.reset_launches()
    got = kf.flash_attention_backward(q, k, v, out, do, lse=lse, **kw)
    assert build.LAUNCHES[kf.BWD] == 1
    assert {key: build.LAUNCHES[name]
            for key, name in kf.BWD_VARIANTS.items()} \
        == {key: int(key == route) for key in kf.BWD_VARIANTS}
    again = kf.flash_attention_backward(q, k, v, out, do, **kw)
    want = kf.flash_attention_backward_plain(q, k, v, out, do, **kw)
    mirror = (kf.flash_attention_backward_mma_plain(q, k, v, out, do, **kw)
              if route == "mma" else want)
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for a, b, w, m, t in zip(got, again, want, mirror, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, b)
        tol = rel * max(float(w.float().abs().max()), 1e-6)
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol)
        if route == "mma":
            _close_to_mirror(a, m)
    last = min(valid, q_offset + tq) if causal else valid
    for a in got[1:]:
        assert not bool((a[:, last:] != 0).any())


def test_flash_bwd_reads_strided_rows(cuda):
    """bf16 q, k and v read through a fused (B, T, H + 2K, hd) projection's
    strides (rows on 16-byte boundaries): the tensor-core backward equals
    its call on contiguous copies bit for bit and holds to its mirror."""
    g = torch.Generator().manual_seed(23)
    b, t, h, kvh, hd = 2, 100, 8, 2, 64
    fused = torch.randn((b, t, h + 2 * kvh, hd), generator=g).to(
        cuda, torch.bfloat16)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kvh], fused[:, :, h + kvh:]
    do = torch.randn((b, t, h, hd), generator=g).to(cuda, torch.bfloat16)
    out = kf.flash_attention(q, k, v)
    build.reset_launches()
    got = kf.flash_attention_backward(q, k, v, out, do)
    assert build.LAUNCHES[kf.BWD_VARIANTS["mma"]] == 1
    want = kf.flash_attention_backward(
        q.contiguous(), k.contiguous(), v.contiguous(), out, do)
    mirror = kf.flash_attention_backward_mma_plain(q, k, v, out, do)
    for a, w, m in zip(got, want, mirror):
        assert torch.equal(a, w)
        _close_to_mirror(a, m)


def test_flash_lse_matches_plain(cuda):
    """The tensor-core forward's log-sum-exp (log2 units) against
    ``flash_attention_lse_plain``, within 1e-4 (float32 sums in another
    order, on values of order 10); its output is the plain forward call's,
    bit for bit."""
    for case in ("offset_ragged", "one_row", "hd32_bidirectional"):
        causal, q_offset, valid = BWD_CASES[case][6:]
        q, k, v, _ = _bwd_inputs(case, torch.bfloat16, cuda)
        kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid)
        out, lse = kf.flash_attention_lse(q, k, v, **kw)
        want = kf.flash_attention_lse_plain(q, k, **kw)
        assert lse.shape == want.shape
        torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)
        if q.shape[1] > 1:
            assert torch.equal(out, kf.flash_attention(q, k, v, **kw))


def test_flash_bwd_kernel_takes_every_gradient(cuda):
    """On the card a call whose inputs need a gradient returns a tensor
    with a ``grad_fn``, and its backward launches the backward kernel
    once (a strided incoming gradient is copied first)."""
    q, k, v, do = _bwd_inputs("gqa_hd128", torch.bfloat16, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    build.reset_launches()
    out = kf.flash_attention(*leaves)
    assert out.grad_fn is not None
    assert build.LAUNCHES["flash_attention_mma"] == 1
    wide = torch.cat([do, do], dim=-1)[..., :do.shape[-1]]
    out.backward(wide)
    assert build.LAUNCHES[kf.BWD] == 1
    assert build.LAUNCHES[kf.BWD_VARIANTS["mma"]] == 1
    want = kf.flash_attention_backward(q, k, v, out.detach(), do)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        assert kf.flash_attention(*leaves).grad_fn is None


def test_flash_bwd_rejects_what_it_does_not_take(cuda):
    q, k, v, do = _bwd_inputs("hd16", torch.bfloat16, cuda)
    out = kf.flash_attention(q, k, v)
    flat = torch.zeros(k.numel() + 1, device=cuda, dtype=torch.bfloat16)
    bad = flat[1:].view(k.shape)
    build.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        kf.flash_attention_backward(q, bad, bad, out, do)
    with pytest.raises(ValueError, match="one dtype"):
        kf.flash_attention_backward(q, k.float(), v.float(), out, do)
    with pytest.raises(ValueError, match="contiguous"):
        kf.flash_attention_backward(q, k, v, out,
                                    torch.cat([do, do], -1)[..., :16])
    with pytest.raises(ValueError, match="lse must be"):
        kf.flash_attention_backward(q, k, v, out, do,
                                    lse=torch.zeros(3, device=cuda))
    with pytest.raises(ValueError, match="lse is the bf16 route's"):
        f = [t.float() for t in (q, k, v, out, do)]
        kf.flash_attention_backward(*f, lse=torch.zeros(3, device=cuda))
    wide = torch.zeros((1, 4, 2, 48), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="head width"):
        kf.flash_attention(wide, wide, wide)
    assert build.LAUNCHES[kf.BWD] == 0


def _cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))


def test_card_training_step_matches_cpu(cuda):
    """minicpm-2b at full width and 2 layers, bf16, the same parameters and
    batch (B 2, S 64) on the CPU and the card, one train step each: the
    loss and grad norm within 1e-2 relative; the gradients, read from the
    first moment (``mu = 0.1 g`` clipped, one step from zero), at a
    relative L2 within 5e-2 of the CPU's leaf by leaf (bf16 products round
    at other places; the card's forward rounds P to bf16), every attention
    weight's nonzero; the backward kernel launched once a layer and the
    forward twice (remat); each matrix's update at cosine >= 0.9 with the
    CPU's."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=2)
    bundle = build_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = DecoderLM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()
              if p.ndim >= 2}
    tc = TrainConfig(peak_lr=1e-3, warmup=0, total_steps=10)
    step = make_train_step(bundle, tc)
    out = []
    for model in (cpu, gpu):
        build.reset_launches()
        opt = init_opt_state(dict(model.named_parameters()), tc.adamw)
        model, opt, metrics = step(model, opt, batch)
        out.append((opt, metrics))
    assert build.LAUNCHES[kf.BWD] == 2
    assert build.LAUNCHES[kf.BWD_VARIANTS["mma"]] == 2
    assert build.LAUNCHES["flash_attention_mma"] == 4
    (c_opt, c_m), (g_opt, g_m) = out
    for key in ("loss", "grad_norm"):
        assert abs(g_m[key].item() / c_m[key].item() - 1) <= 1e-2, key
    g_params = dict(gpu.named_parameters())
    for n, p in cpu.named_parameters():
        want, got = c_opt["mu"][n], g_opt["mu"][n].cpu()
        assert (got - want).norm() <= 5e-2 * want.norm(), n
        if ".attn." in n:
            assert got.abs().sum() > 0, n
        if n in before:
            assert _cosine(g_params[n].detach().cpu().float()
                           - before[n].float(),
                           p.detach().float() - before[n].float()) >= 0.9, n


# (b, tq, tk, h, kv heads, hd, causal, q_offset, kv_valid_len, window): head
# width 192 (nemotron-4-340b's 96 heads over 8) and sliding windows of 128
# and 1 024 keys, shorter than a tile, across tiles and longer than the
# keys, in every forward kernel (Tq = 1: the split-KV decode, whose window
# starts mid-split or on a split boundary)
WINDOW_FLASH_CASES = {
    "hd192_prefill": (2, 130, 200, 12, 2, 192, True, 0, 130, 0),
    "hd192_bidirectional": (1, 70, 70, 4, 4, 192, False, 0, 70, 0),
    "hd192_decode": (4, 1, 384, 96, 8, 192, True, 351, 352, 0),
    "hd192_nemotron_prefill": (1, 320, 384, 96, 8, 192, True, 0, 320, 0),
    "window128_prefill": (2, 320, 384, 8, 2, 64, True, 0, 320, 128),
    "window1024_prefill": (1, 1500, 1536, 4, 4, 64, True, 0, 1500, 1024),
    "window5_offset": (2, 70, 256, 4, 2, 32, True, 100, 170, 5),
    "window_longer_than_keys": (2, 100, 100, 4, 2, 16, True, 0, 100, 4096),
    "window_bidirectional": (1, 130, 130, 4, 2, 64, False, 0, 130, 40),
    "window128_decode": (4, 1, 1536, 8, 2, 64, True, 1200, 1201, 128),
    "window_decode_on_split": (2, 1, 512, 8, 8, 64, True, 319, 320, 192),
    "window1024_decode": (2, 1, 4096, 8, 2, 128, True, 4095, 4096, 1024),
    "window_hd192_prefill": (1, 200, 256, 8, 2, 192, True, 0, 200, 128),
    "window_hd192_decode": (2, 1, 512, 96, 8, 192, True, 400, 401, 128),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(WINDOW_FLASH_CASES))
def test_flash_attention_window_and_hd192_match_plain(cuda, case, dtype):
    """Each forward kernel at head width 192 and under a sliding window
    against the plain version (float32 within 2e-3, bf16 within 2e-2), one
    launch of the kernel the dtype and Tq select; a split-KV call also
    against its float32 mirror."""
    b, tq, tk, h, kvh, hd, causal, q_offset, valid, w = \
        WINDOW_FLASH_CASES[case]
    g = torch.Generator().manual_seed(tk + w)
    q = torch.randn((b, tq, h, hd), generator=g).to(cuda, dtype)
    k = torch.randn((b, tk, kvh, hd), generator=g).to(cuda, dtype)
    v = torch.randn((b, tk, kvh, hd), generator=g).to(cuda, dtype)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid,
              sliding_window=w)
    build.reset_launches()
    got = kf.flash_attention(q, k, v, **kw)
    variant = "fma" if dtype == torch.float32 else (
        "split_kv" if tq == 1 else "mma")
    assert {key: build.LAUNCHES[name] for key, name in kf.VARIANTS.items()} \
        == {key: int(key == variant) for key in kf.VARIANTS}
    want = kf.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    tol = dict(rtol=2e-3, atol=2e-3) if dtype == torch.float32 \
        else dict(rtol=0, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if variant == "split_kv":
        mirror = kf.flash_decode_split_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), mirror.float(), rtol=0,
                                   atol=2e-2)


# (b, tq, tk, h, kv heads, hd, causal, q_offset, kv_valid_len, window)
WINDOW_BWD_CASES = {
    "hd192_train": (1, 130, 130, 12, 2, 192, True, 0, 130, 0),
    "hd192_offset": (1, 37, 100, 4, 2, 192, True, 20, 57, 0),
    "hd192_bidirectional": (1, 70, 70, 4, 4, 192, False, 0, 70, 0),
    "window128_train": (2, 256, 256, 8, 2, 64, True, 0, 256, 128),
    "window9_ragged": (2, 70, 70, 4, 2, 32, True, 0, 70, 9),
    "window_offset": (2, 65, 130, 4, 2, 64, True, 50, 115, 30),
    "window_bidirectional": (1, 100, 100, 4, 2, 16, False, 0, 100, 40),
    "window_hd192": (1, 200, 200, 8, 2, 192, True, 0, 200, 100),
    "window_hd128_gqa": (1, 160, 160, 16, 4, 128, True, 0, 160, 70),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(WINDOW_BWD_CASES))
def test_flash_bwd_window_and_hd192_match_plain(cuda, case, dtype):
    """Both backward routes at head width 192 and under a sliding window,
    as ``test_flash_bwd_matches_plain``: one launch of the route's kernels,
    a second call equal bit for bit, float32 within 1e-4 of the largest
    gradient, bf16 within 2^-7 of it and to its mirror; dK and dV of the
    keys past the last visible one exactly zero."""
    b, tq, tk, h, kvh, hd, causal, q_offset, valid, w = \
        WINDOW_BWD_CASES[case]
    g = torch.Generator().manual_seed(tk + h + w)
    q, do = (torch.randn((b, tq, h, hd), generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn((b, tk, kvh, hd), generator=g).to(cuda, dtype)
            for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid,
              sliding_window=w)
    route = "mma" if dtype == torch.bfloat16 else "fma"
    if route == "mma":
        out, lse = kf.flash_attention_lse(q, k, v, **kw)
    else:
        out, lse = kf.flash_attention(q, k, v, **kw), None
    build.reset_launches()
    got = kf.flash_attention_backward(q, k, v, out, do, lse=lse, **kw)
    assert {key: build.LAUNCHES[name]
            for key, name in kf.BWD_VARIANTS.items()} \
        == {key: int(key == route) for key in kf.BWD_VARIANTS}
    again = kf.flash_attention_backward(q, k, v, out, do, **kw)
    want = kf.flash_attention_backward_plain(q, k, v, out, do, **kw)
    mirror = (kf.flash_attention_backward_mma_plain(q, k, v, out, do, **kw)
              if route == "mma" else want)
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for a, b_, wt, m, t in zip(got, again, want, mirror, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, b_)
        tol = rel * max(float(wt.float().abs().max()), 1e-6)
        torch.testing.assert_close(a.float(), wt.float(), rtol=0, atol=tol)
        if route == "mma":
            _close_to_mirror(a, m)
    last = min(valid, q_offset + tq) if causal else valid
    for a in got[1:]:
        assert not bool((a[:, last:] != 0).any())
