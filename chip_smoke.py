#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,ivf
    python3 chip_smoke.py --phases build,kernels,ladder
    python3 chip_smoke.py --phases build,kernels,filter
    python3 chip_smoke.py --phases build,kernels,stream
    python3 chip_smoke.py --phases build,kernels,engine
    python3 chip_smoke.py --phases build,kernels,rag
    python3 chip_smoke.py --phases build,profile      # opt-in breakdown

Phases, in order; any failure raises and the script exits nonzero:

1. build    — compile every ``src/repro_torch/csrc/*.cu`` with nvcc (one
              process per source, all at once) and print the seconds.
2. kernels  — each hand-written kernel against its plain torch version on
              the card, at the shapes the main path gives it: ``binarize``
              (D in {100, 384, 768, 1536, 3072}, ragged N; sign words exact,
              strong bits only within 4 ulp of tau), ``bq_dist_rows``
              (K from the IVF build's top-up of 32 to a search batch's
              50 880 gathered list members), ``bq_pairwise`` (C = 72,
              consolidation's pool, and 128, a build chunk's) and
              ``list_scan`` (D in {64, 100, 384, 768, 1536, 3072}, L in
              {45, 316, 1000}, Q in {1, 256, 8193}), ``hamming_dist_rows``
              and ``hamming_pairwise`` (D in {17, 64, 100, 384, 768, 1536,
              3072}, ragged B, K and C, K = 34 080 at D = 768, C from 1 to
              1024 with duplicate ids, each pool equal to its transpose);
              all exactly equal.  ``flash_attention``
              (``FLASH_CASES``), each call through the kernel its dtype and
              Tq select (float32: the CUDA-core kernel; bf16 Tq = 1: the
              split-KV decode, also held to its float32 mirror; bf16 Tq >
              1: the tensor-core kernel), float32 within 2e-3 and bf16
              within 2e-2 of its plain version: the RAG path's shapes
              (hd = 64, H = K = 36, causal: embed 64 docs x T = 64;
              prefill B = 8, Tq = 320 over a 384-row cache; decode B = 8,
              Tq = 1 at q_offset 320 and 351), decode with kv_valid_len
              1, 63, 64 and 65 (around a 64-key split), fully masked
              splits, a 4096-row cache, GQA groups of 4, hd in {16, 32,
              128}, prefill at q_offset 100 with a ragged Tq = 70, a
              ragged embed, bf16 K/V read through a stacked cache's and a
              fused buffer's strides, and a misaligned K that must raise.
              Then each kernel's, its plain version's and one
              PyTorch call's time (a matmul for the distance kernels,
              ``scaled_dot_product_attention`` for flash) on those
              main-path inputs: device time and stream time (see
              ``time_ms``); logged beside them, not in the kernels line:
              ``bq_dist_rows`` at K = 5 256 (the streaming repair's
              candidate row, 72 + 72 x 72), 34 080 and 50 880 (the IVF
              build chunk and search batch), ``bq_pairwise`` at C = 72,
              ``list_scan`` at Q = 8192, ``hamming_pairwise`` at C = 72 and
              ``hamming_dist_rows`` at K = 34 080 (its library bmm over
              26.8 GB of float32 levels, gathered when it is timed).
3. parity   — the same N = 4000 builds and searches on ``device="cpu"`` and
              on the card, beam-searched and IVF-seeded: identical
              partition, adjacency, medoid and candidate ids; the filter
              phase's labels and predicates on the beam-built graph: equal
              entries and plans, identical ids with ``rerank=False`` and
              ids matched by ``ids_match`` reranked; and
              ``build(nav="auto")`` on sift-like (red: float32 x4) and on
              cohere-surrogate (green: bq2): equal policies, ids matched by
              ``ids_match``; the streaming mutation script on the
              beam-built graph with its labels (``parity_stream``: insert
              400, delete 300 with the medoid, graph and brute searches,
              consolidate, insert into the reclaimed slots, freeze):
              identical state, ids and frozen graph, and the card's
              mutable archive loaded on the CPU; ``graph_report()`` (S =
              256, k = 8) of the beam-built graph and of the stream
              script's mutated graph: integer fields and verdicts
              identical, edge agreement within 2 / (S k); one
              ``QueryEngine`` request script (``parity_engine``: three
              tenants, a quota, deadlines, a shadow lane at rate 4)
              under the same scripted clock: identical tickets (status,
              degrade rungs, latency, plan signature, ids; scores within
              1e-6), identical sampled rows and drained recalls, each the
              row's exact recall; and ``minicpm-2b`` at
              full width and 2 layers,
              drawn on the CPU and copied to the card: 2 prompts of 48
              tokens, prefill and 8 greedy decode steps (the card fed the
              CPU's tokens), every logit within 0.1 and equal argmax
              where the CPU's top-2 gap exceeds 0.2, mean-pooled
              embeddings at cosine >= 0.999.
4. main     — the main path at deployment size: cohere-surrogate (768-d),
              N = 100 000, 1 000 queries, ``BuildParams()`` defaults;
              build, search at k = 10, ef = 64, recall@10 against exact
              search (gate 0.80), save, load, search again (identical
              ids).  Launch counts are reset just before this phase and
              read just after; every kernel must have launched, and
              the ``bq_pairwise`` launches are printed by pool size.
5. ivf      — the IVF path at the same size: ``BuildParams(
              ivf_candidates=True)``, partition and linking timed apart;
              search ``nav="bq2"`` at ef = 64 (recall gate 0.80) and
              ``nav="ivf"`` at ef = 128 with default probes and with
              ceil(3L/4) probes (gate: graph recall - 0.02); save, load,
              ``nav="ivf"`` again (identical ids).  Launch counts as in 4;
              all four kernels must have launched.
6. ladder   — the metric ladder at the same size (1 000 queries, k = 10,
              ef = 64): a bq1 build (``BuildParams()``) over the first
              ``LADDER_BQ1_N`` = 50 000 rows (the script's one cut of
              depth, the same on every host) searched with ``nav="bq1"``
              against their exact truth (recall gate 0.50); phase 4's bq2
              graph (built
              again when phase 4 did not run) searched with ``nav`` in
              {bq2, bq1, adc, float32} (gate 0.50 each) and with bq2 +
              ``adaptive=True`` (gate: plain bq2 recall - 0.005; the
              escalated share is printed); then ``probe_corpus`` (sample
              1024) on cohere-surrogate, sift-like and random-sphere at
              N = 100 000, on the card and on the CPU: verdicts and
              policies must agree, and must be green, red, red.  Launch
              counts as in 4; both hamming entry points and ``list_scan``
              must have launched, and the bq1 build's ``hamming_pairwise``
              launches are printed by pool size.  The adaptive search's
              escalations are counted by a hub on the index's plan cache.
filter      — filtered search through query plans on phase 4's graph and
              phase 5's IVF index (each built here when its phase did not
              run): 8 labels, each row's membership drawn from seed 0 at
              rates ``FILTER_RATES`` (0.5 down to 0.001), per-label entries
              (``build_label_entries(min_count=32)``, timed); then 1 000
              queries at k = 10, ef = 64: unfiltered (ids equal to phase
              4's), labels 0-3 (graph route, widened ef), labels 4-6
              (brute route), ``All(0, 1)``, ``Any(4, 5)``, ``Not(0)``,
              label 5 with ``rerank=False``, label 0 with ``nav="bq1"``,
              label 1 with ``adaptive=True`` and label 1 with
              ``nav="ivf"`` on the IVF index; route, ef, QPS and recall
              printed for each.  Gates: every returned id matches its
              predicate (the membership matrix, exactly); the reranked
              brute route's ids match exact filtered cosine top-10 (up to
              1e-6 score ties), the unreranked one's scores equal an exact
              bq2 scan's; graph-route recall@10 against the filtered truth
              >= phase 4's recall - 0.05, ivf-route >= phase 5's default
              ``nav="ivf"`` recall - 0.05.  Then every plan warmed at the
              buckets (8, 32, 128, 256) and the whole set run again, each
              search at one of those buckets in turn: zero retraces and no
              new miss.  Launch counts as in 4: binarize,
              ``bq_dist_rows``, ``list_scan`` and ``hamming_dist_rows``
              must have launched.
stream      — the streaming index on phase 4's graph (built here when
              phase 4 did not run): ``MutableQuIVerIndex.from_index`` (2x
              headroom) with a ``DriftMonitor`` armed; zero churn: 1 000
              queries at k = 10, ef = 64, ids and scores equal to phase
              4's, and the frozen snapshot's too; the mutable search
              (direct beam) and phase 4's (plans) timed A B A B on the
              same graph.  Then ``STREAM_CYCLES`` = 2 cycles (delete
              seeds 0, 1) of FreshDiskANN churn at the reference
              benchmark's rate, ``STREAM_CHURN`` = 5%: delete 5 000 live
              ids, search, ``consolidate``, search, re-insert the same 5 000
              vectors, search.  Gates: no deleted id returned; 5 000 slots
              reclaimed and exactly those reused; recall@10 against the
              live truth at ef = 64 after consolidate >= before it -
              0.02; the accumulator equal to
              ``ProbeAccumulator.from_words`` of the live words after
              every mutation; no drift alarm; and, at a search as wide as
              the insert's own beam (ef = ``ef_construction`` = 128, where
              the reference sets its bars: its tests search at ef 48 over
              ef_construction 32, its churn benchmark at ef =
              ef_construction), the re-inserted vectors found at k = 1 in
              > 0.9 of cases and recall@10 after the re-insert (phase 4's
              corpus again) >= phase 4's graph's at that ef - 0.03.  Every
              step is also searched at ef = 64 and printed, beside the
              self-hit of the first 1 000 of them before the churn (at
              both widths) and the re-inserted rows' in-degree.  Then ``freeze``: its recall
              within 0.005 of the mutable search's.  A graph monitor is
              armed (``attach_graph_monitor``): each consolidation's
              X-ray band and score are printed, and its ``n_live`` must
              be the live count.
              Launch counts as in 4: binarize, ``bq_dist_rows`` and
              ``bq_pairwise`` must have launched.
engine      — the serving engine on phase 4's graph (built here when
              phase 4 did not run): ``QueryEngine(index, shadow={"rate":
              8})`` with ``RemediationPolicy(engine, auto=True)``, warmed
              at the buckets 8-256 for ef 64 and its deadline rungs 32
              and 16; phase 4's first 1 000 queries as 640 requests of
              three tenants, submitted in order and pumped every 64:
              ``rag`` 512 singletons (``recall_slo`` 0.75), ``batch`` 24
              requests of 16 (half with ``deadline_ms`` 1), ``capped``
              104 singletons (``set_quota(qps=50, burst=8)``); twice.
              Gates: every undegraded ``done`` request's ids equal phase
              4's direct search (``ids_match``); rejected and dropped
              tickets -1 / -inf, rejections on ``capped`` only, requests
              = done + dropped + rejected; every drained shadow recall
              its row's exact recall against phase 4's truth,
              ``host_shadow_bytes`` > 0; ``recall_slo`` green, then
              ``batch``'s SLO armed at ``ENGINE_FORCED_SLO`` = 1.001
              (recall@10 here is 0.0 or 1.0 a query, so the ledger's
              median rule breaches no floor <= 1.0) and its requests
              served again: the breach re-probes (green) and escalates
              ef 64 -> 128, then ``resolve()``; the second pass 0 retraces; the
              swap onto phase 5's IVF index (built here when phase 5 did
              not run) with its warmup, 256 ``rag`` singletons at the
              default nav and 256 at ``nav="ivf"``: its direct-search
              ids, 0 retraces; ``graph_report()`` of phase 4's graph (S =
              256, k = 8): out- and in-degree means and reciprocity equal
              to the host adjacency's, unreachable rows and hop radius to
              a host BFS from the medoid (scipy), verdict and score
              printed.  Printed: requests/s and queries/s a pass, the
              window's split (coalesce, launch, finalize, shadow), p50 /
              p99 by tenant, the same 64 singletons through
              ``index.search`` one at a time, the re-probe's and the
              X-ray's seconds.  Launch counts as in 4: binarize,
              ``bq_dist_rows`` and ``list_scan`` must have launched.
7. rag      — LM serving with RAG: ``minicpm-2b`` at full width and depth
              (40 layers, d 2304, 36 heads, vocab 122 880, bf16, weights
              drawn from seed 0) on the card; embed 8 192 + 256 seeded
              documents of 64 tokens with ``mean_pool_embedder`` (batches
              of 64), build a ``QuIVerIndex`` (``BuildParams()``) over the
              8 192, probe it, recall@10 at ef = 64 of the 256 held-out
              documents against ``flat_search`` (printed, not gated); then
              8 prompts of 64 tokens through ``Retriever(k=4, ef=64)`` and
              ``ServeEngine.generate`` (prefill T = 320, ``max_seq`` 384,
              32 greedy tokens), twice, with identical tokens; every
              retrieved id in range and every context row the document's
              tokens.  Launch counts are reset before each step and read
              after it: ``flash_attention`` launches 40 times a call of
              embed, prefill and decode, every embed and prefill launch on
              the tensor-core kernel and every decode launch on the
              split-KV kernel, and the bq kernels in the build.  Each
              step's ms a call is printed with the flash kernel's share
              (its launches x its phase-2 device time).  One retrieval
              of the 8 prompts through ``Retriever(engine=QueryEngine(
              index, obs=False))``: the direct ``Retriever``'s documents.
              Then two labels on the 8 192 documents and one filtered
              ``Retriever.augment`` of the 8 prompts: every retrieved
              document carries label 1.
An opt-in eighth phase, ``profile``, is not run by default: it profiles a
few build chunks at the main path's size with ``torch.profiler`` and
prints the device's busy share, device time by kernel, and the port's own
kernels' share of it.

The last three lines of standard output are the card's name and power
limit (``nvidia-smi``), one JSON line of per-kernel numbers (``launches``
sums phases 4, 5, 6, filter, stream, engine and 7), and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "parity", "main", "ivf", "ladder", "filter",
          "stream", "engine", "rag")
OPT_IN = ("profile",)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float32
# CUDA-core rate, used as the rate of binarize's and hamming's integer and
# logic operations (Hopper issues int32 at no more than that rate, so the
# bound derived from it is a lower bound), the dense bf16 tensor-core rate,
# the bound of attention's products, and the dense int8 tensor-core rate:
# the Table-1 similarity is the integer dot product of +-1/+-2 levels, so
# list_scan, bq_dist_rows and bq_pairwise are reckoned as int8 products of
# 2 * D operations a (query, row) pair
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
TENSOR_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# per float of binarize: abs, add, two compares
OPS_PER_ELEMENT = 4
# integer operations per word pair of the 1-bit Hamming distance: xor,
# popcount, add
OPS_PER_SIGN_WORD_PAIR = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def clocks() -> str:
    """SM clock (now / max), power draw and temperature: a run whose
    compute-bound kernels slow down shows it here."""
    return nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")


def bound(nbytes: float, ops: float,
          ops_per_s: float = CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> tuple:
    """(device ms, stream ms) of one call of ``fn``.

    Stream ms: CUDA events around ``reps`` back-to-back calls, over
    ``reps``; where the host enqueues slower than the card runs, this
    measures the host.  Device ms: the same, but behind a spin kernel
    (``torch.cuda._sleep``) long enough for the host to enqueue every call
    first, so the card runs them back to back and the host's launch
    overhead drops out.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run() -> float:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    stream_ms = run()
    # ~2e6 cycles a millisecond at the H100's 1.98 GHz: spin for twice the
    # stream-timed run, plus 5 ms
    torch.cuda._sleep(int(2e6 * (2 * stream_ms * reps + 5)))
    return run(), stream_ms


def random_table(torch, n: int, dim: int, seed: int):
    """(n, 2W) int32 signatures of seeded random vectors, on the card."""
    from repro_torch.kernels.binarize import binarize_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device="cuda")
    return binarize_plain(x)


def phase_kernels(torch) -> dict:
    """Every kernel against its plain version; numbers at main-path shapes."""
    from repro_torch.core import bq
    from repro_torch.kernels import binarize as kb
    from repro_torch.kernels import bq_distance as kd
    from repro_torch.kernels import list_scan as kl

    out = {}
    g = torch.Generator(device="cuda").manual_seed(11)
    flips_total = 0
    for dim in (100, 384, 768, 1536, 3072):
        x = torch.randn((4099, dim), generator=g, device="cuda")
        got = kb.binarize_cuda(x)
        want = kb.binarize_plain(x)
        torch.cuda.synchronize()
        flips = kb.strong_bit_flips(got.cpu().numpy(), want.cpu().numpy(),
                                    x.cpu().numpy())
        flips_total += flips
        log(f"  binarize D={dim} N=4099: sign words exact, "
            f"{flips} strong-bit flips within 4 ulp of tau, "
            f"exact={bool(torch.equal(got, want))}")

    # binarize at the main path's encode shape: N = 100 000, D = 768
    x = torch.randn((100_000, 768), generator=g, device="cuda")
    got, want = kb.binarize_cuda(x), kb.binarize_plain(x)
    flips = kb.strong_bit_flips(got.cpu().numpy(), want.cpu().numpy(),
                                x.cpu().numpy())
    flips_total += flips
    bits = bq.unpack_bits(got, got.shape[1] * 32).int()
    ref_bits = bq.unpack_bits(want, want.shape[1] * 32).int()
    nb, ops = x.numel() * 4 + got.numel() * 4, OPS_PER_ELEMENT * x.numel()
    b_ms, b_by = bound(nb, ops)
    out["binarize"] = {
        "name": "binarize", "route": "cuda",
        "source": "src/repro_torch/csrc/binarize.cu",
        "replaces": "src/repro/kernels/binarize.py:21",
        "max_abs_err": float((bits - ref_bits).abs().max()),
        "fns": (partial(kb.binarize_cuda, x), partial(kb.binarize_plain, x),
                None),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": [100_000, 768], "strong_bit_flips": flips_total,
    }
    log(f"  binarize: {flips_total} strong-bit flips in all, none outside "
        "the band")

    n_table = 100_000
    for dim in (384, 768, 1536):
        table = random_table(torch, n_table, dim, seed=dim)
        mask = bq.valid_mask(dim, device="cuda")
        w = mask.shape[0]
        # the beam hop (72, 288), the IVF-seeded build's random top-up (32),
        # the streaming repair's candidate row (72 + 72 * 72: a row's live
        # neighbours and its dead neighbours' out-edges), the IVF build
        # chunk's gathered list members at N = 100 000 (71 lists x cap
        # 480) and a search batch's at the default 106 probes
        for k in (32, 72, 4 * 72, 72 + 72 * 72, 71 * 480, 106 * 480):
            ids = torch.randint(0, n_table, (256, k), generator=g,
                                device="cuda", dtype=torch.int32)
            q = table[torch.randint(0, n_table, (256,), generator=g,
                                    device="cuda")]
            got = kd.dist_rows(q, ids, table, mask)
            want = kd.dist_rows_plain(q, ids, table, mask)
            if not torch.equal(got, want):
                raise AssertionError(f"bq_dist_rows differs at D={dim} K={k}")
            log(f"  bq_dist_rows B=256 K={k} D={dim}: exact")
            if dim == 768 and k in (72, 72 + 72 * 72, 71 * 480, 106 * 480):
                uniq = torch.unique(ids).numel()
                nb = uniq * 8 * w + ids.numel() * 4 + q.numel() * 4 \
                    + w * 4 + got.numel() * 4
                b_ms, b_by = bound(nb, 2 * ids.numel() * dim,
                                   INT8_OPS_PER_S)
                # the library call: one bmm of the decoded levels (gather
                # and decode outside the timed call)
                lr = kd.masked_levels(table, mask)[ids.long()]
                lq = kd.masked_levels(q, mask)[:, :, None]
                check_library("bq_dist_rows", torch.bmm(lr, lq)[..., 0], got)
                key = "bq_dist_rows" if k == 72 else f"bq_dist_rows_k{k}"
                out[key] = {
                    "name": "bq_dist_rows", "route": "cuda",
                    "source": "src/repro_torch/csrc/bq_distance.cu",
                    "replaces": "src/repro/kernels/bq_distance.py:25",
                    "max_abs_err": float((got - want).abs().max()),
                    # partial binds these tensors now; the loop rebinds
                    # the names for the next shapes
                    "fns": (partial(kd.dist_rows, q, ids, table, mask),
                            partial(kd.dist_rows_plain, q, ids, table, mask),
                            partial(torch.bmm, lr, lq)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "shape": [256, k, dim],
                    # the repair's, the IVF build chunk's and the search
                    # batch's shapes: logged, not in the kernels line
                    "log_only": k != 72,
                }
        for c in (72, 128):
            ids = torch.randint(0, n_table, (256, c), generator=g,
                                device="cuda", dtype=torch.int32)
            got = kd.pairwise(ids, table, mask)
            want = kd.pairwise_plain(ids, table, mask)
            if not torch.equal(got, want):
                raise AssertionError(f"bq_pairwise differs at D={dim} C={c}")
            log(f"  bq_pairwise B=256 C={c} D={dim}: exact")
            if dim == 768:
                uniq = torch.unique(ids).numel()
                nb = uniq * 8 * w + ids.numel() * 4 + w * 4 + got.numel() * 4
                b_ms, b_by = bound(nb, 2 * got.numel() * dim,
                                   INT8_OPS_PER_S)
                lp = kd.masked_levels(table[ids.long()], mask)
                lpt = lp.transpose(1, 2)
                check_library("bq_pairwise", torch.bmm(lp, lpt), got)
                # a build chunk's pool (prune_pool); consolidation's pool
                # (R_total) is logged, not in the kernels line
                key = "bq_pairwise" if c == 128 else f"bq_pairwise_c{c}"
                out[key] = {
                    "name": "bq_pairwise", "route": "cuda",
                    "source": "src/repro_torch/csrc/bq_distance.cu",
                    "replaces": "src/repro/kernels/bq_distance.py:25",
                    "max_abs_err": float((got - want).abs().max()),
                    "fns": (partial(kd.pairwise, ids, table, mask),
                            partial(kd.pairwise_plain, ids, table, mask),
                            partial(torch.bmm, lp, lpt)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "shape": [256, c, dim],
                    "log_only": c != 128,
                }

    # list_scan: one query, ragged Q and L, both tile shapes, and D from 64
    # to 3072 (L = 1000: 768 KB of centroids)
    for dim in (64, 100, 384, 768, 1536, 3072):
        mask = bq.valid_mask(dim, device="cuda")
        for n_lists in (45, 316, 1000):
            for n_q in (1, 256, 8193):
                table = random_table(torch, n_q + n_lists, dim,
                                     seed=dim + n_lists + n_q)
                q, cent = table[:n_q], table[n_q:]
                got = kl.scan(q, cent, mask)
                want = kl.scan_plain(q, cent, mask)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"list_scan differs at D={dim} L={n_lists} Q={n_q}")
        log(f"  list_scan D={dim} L in (45, 316, 1000) Q in (1, 256, 8193): "
            "exact")
    # the most-launched shape (a search batch or build chunk against the
    # centroids at N = 100 000), and the partition's assignment chunk
    for key, n_q in (("list_scan", 256), ("list_scan_q8192", 8192)):
        dim, n_lists = 768, 316
        mask = bq.valid_mask(dim, device="cuda")
        w = mask.shape[0]
        table = random_table(torch, n_q + n_lists, dim, seed=n_q)
        q, cent = table[:n_q], table[n_q:]
        got, want = kl.scan(q, cent, mask), kl.scan_plain(q, cent, mask)
        lq, lct = kd.masked_levels(q, mask), kd.masked_levels(cent, mask).T
        check_library("list_scan", torch.matmul(lq, lct), got)
        nb = (n_q + n_lists) * 8 * w + w * 4 + got.numel() * 4
        b_ms, b_by = bound(nb, 2 * got.numel() * dim, INT8_OPS_PER_S)
        out[key] = {
            "name": "list_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/list_scan.cu",
            "replaces": "src/repro/kernels/list_scan.py:30",
            "max_abs_err": float((got - want).abs().max()),
            "fns": (partial(kl.scan, q, cent, mask),
                    partial(kl.scan_plain, q, cent, mask),
                    partial(torch.matmul, lq, lct)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": [n_q, n_lists, dim],
            # logged, not in the kernels line
            "log_only": key != "list_scan",
        }
    out.update(hamming_kernels(torch, g))
    out.update(flash_kernels(torch))
    torch.cuda.synchronize()
    return out


def sign_levels(torch, words, dim: int):
    """(..., W) sign words -> (..., 32W) float32 +-1 levels, 0 past ``dim``:
    the Hamming distance of two rows is (dim - their dot product) / 2."""
    from repro_torch.core import bq

    bits = bq.unpack_bits(words, words.shape[-1] * 32).to(torch.float32)
    keep = (torch.arange(bits.shape[-1], device=bits.device) < dim)
    return (2.0 * bits - 1.0) * keep


def hamming_kernels(torch, g) -> dict:
    """Both hamming entry points against their plain versions: gathers of
    K up to 34 080 and pools of C from 1 to 1024 (some with duplicate ids;
    a pool's output must equal its transpose), at D from 17 to 3072.  The
    numbers at the bq1 path's shapes (D = 768): the beam hop's B = 256,
    K = 72, the prune pool's B = 256, C = 128, and logged beside them
    consolidation's C = 72 and the gather at K = 34 080."""
    from repro_torch.core import bq
    from repro_torch.kernels import hamming as kh

    out = {}
    n_table = 100_000
    for dim in (17, 64, 100, 384, 768, 1536, 3072):
        table = random_table(torch, n_table, dim, seed=dim + 1)
        mask = bq.valid_mask(dim, device="cuda")
        w = mask.shape[0]
        rows = ((256, 72), (13, 777), (256, 288))
        for b, k in rows + (((256, 34_080),) if dim == 768 else ()):
            ids = torch.randint(0, n_table, (b, k), generator=g,
                                device="cuda", dtype=torch.int32)
            q = table[torch.randint(0, n_table, (b,), generator=g,
                                    device="cuda"), :w].contiguous()
            got = kh.dist_rows(q, ids, table)
            want = kh.dist_rows_plain(q, ids, table)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"hamming_dist_rows differs at D={dim} B={b} K={k}")
            if dim == 768 and b == 256 and k in (72, 34_080):
                uniq = torch.unique(ids).numel()
                nb = uniq * 4 * w + ids.numel() * 4 + q.numel() * 4 \
                    + got.numel() * 4
                b_ms, b_by = bound(nb, OPS_PER_SIGN_WORD_PAIR * ids.numel()
                                   * w)
                # the library call: one bmm of the +-1 sign levels (gather
                # and decode outside the timed call).  At K = 34 080 the
                # float32 levels take 26.8 GB, more than is left beside
                # bq_dist_rows' levels, so phase_times gathers them when
                # it reaches this record and frees them right after
                library = partial(hamming_library, torch, table[:, :w], q,
                                  ids, dim, got)
                if k == 72:
                    library = library()
                key = "hamming_dist_rows" if k == 72 \
                    else f"hamming_dist_rows_k{k}"
                out[key] = {
                    "name": "hamming_dist_rows", "route": "cuda",
                    "source": "src/repro_torch/csrc/hamming.cu",
                    "replaces": "src/repro/kernels/hamming.py:17",
                    "max_abs_err": float((got - want).abs().max()),
                    "fns": (partial(kh.dist_rows, q, ids, table),
                            partial(kh.dist_rows_plain, q, ids, table),
                            library),
                    "library_gathered_late": k != 72,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "shape": [b, k, dim],
                    "log_only": k != 72,
                }
        # (B, C, pools repeat their first half); distinct ids at C = 256
        # and 1024 too, where a repeated half would hide a tile of the
        # second launch read or written in place of another
        pools = ((256, 128, False), (7, 37, False), (64, 72, False),
                 (256, 72, False), (8, 256, False), (2, 1024, False),
                 (256, 1, True), (64, 72, True), (16, 129, True),
                 (8, 256, True), (2, 1024, True))
        for b, c, dup in pools:
            ids = torch.randint(0, n_table, (b, c), generator=g,
                                device="cuda", dtype=torch.int32)
            if dup:
                ids[:, c // 2:] = ids[:, :c - c // 2].clone()
            got = kh.pairwise(ids, table, mask)
            want = kh.pairwise_plain(ids, table, mask)
            if not (torch.equal(got, want)
                    and torch.equal(got, got.transpose(1, 2))):
                raise AssertionError(
                    f"hamming_pairwise differs at D={dim} B={b} C={c}")
            if dim == 768 and b == 256 and c in (72, 128):
                uniq = torch.unique(ids).numel()
                nb = uniq * 4 * w + ids.numel() * 4 + got.numel() * 4
                b_ms, b_by = bound(nb, OPS_PER_SIGN_WORD_PAIR * got.numel()
                                   * w)
                lp = sign_levels(torch, table[ids.long(), :w], dim)
                lpt = lp.transpose(1, 2)
                check_library("hamming_pairwise",
                              (dim - torch.bmm(lp, lpt)) / 2, got)
                # a build chunk's pool (prune_pool); consolidation's pool
                # (R_total) is logged, not in the kernels line
                key = "hamming_pairwise" if c == 128 \
                    else f"hamming_pairwise_c{c}"
                out[key] = {
                    "name": "hamming_pairwise", "route": "cuda",
                    "source": "src/repro_torch/csrc/hamming.cu",
                    "replaces": "src/repro/kernels/hamming.py:17",
                    "max_abs_err": float((got - want).abs().max()),
                    "fns": (partial(kh.pairwise, ids, table, mask),
                            partial(kh.pairwise_plain, ids, table, mask),
                            partial(torch.bmm, lp, lpt)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "shape": [b, c, dim],
                    "log_only": c != 128,
                }
        log(f"  hamming D={dim}: dist_rows at (B, K) in {rows}"
            f"{' and (256, 34080)' if dim == 768 else ''}, pairwise at "
            f"(B, C) in {[(b, c) for b, c, dup in pools if not dup]} and, "
            f"with duplicate ids, {[(b, c) for b, c, dup in pools if dup]}:"
            " exact, each pool equal to its transpose")
    return out


def hamming_library(torch, sign_words, q, ids, dim: int, got):
    """``hamming_dist_rows``' library call: one bmm of the gathered float32
    +-1 sign levels, checked to give the kernel's distances ``got``."""
    lr = sign_levels(torch, sign_words, dim)[ids.long()]
    lq = sign_levels(torch, q, dim)[:, :, None]
    check_library("hamming_dist_rows",
                  (dim - torch.bmm(lr, lq)[..., 0]) / 2, got)
    return partial(torch.bmm, lr, lq)


def flash_bound(b, tq, h, kvh, hd, causal, q_offset, valid, elem):
    """(ms, "bytes" or "operations") for one attention call: 4 hd flops for
    each visible (row, key) pair at the bf16 tensor-core rate, against Q,
    the visible K/V rows and O moved once."""
    rows = [min(valid, q_offset + i + 1) if causal else valid
            for i in range(tq)]
    flops = 4 * hd * sum(rows) * b * h
    nbytes = elem * hd * (2 * b * tq * h + 2 * b * kvh * max(rows))
    return bound(nbytes, flops, TENSOR_FLOPS_PER_S)


# (label, b, tq, tk, h, kv heads, hd, q_offset, kv_valid_len); each in
# float32 (the CUDA-core kernel) and bf16 (Tq = 1: split-KV; else the
# tensor-core kernel)
FLASH_CASES = [
    ("embed", 64, 64, 64, 36, 36, 64, 0, 64),
    ("prefill", 8, 320, 384, 36, 36, 64, 0, 320),
    ("decode", 8, 1, 384, 36, 36, 64, 320, 321),
    ("decode", 8, 1, 384, 36, 36, 64, 351, 352),
    # kv_valid_len before, on and after a split boundary (64 keys)
    ("decode", 8, 1, 384, 36, 36, 64, 0, 1),
    ("decode", 8, 1, 384, 36, 36, 64, 62, 63),
    ("decode", 8, 1, 384, 36, 36, 64, 63, 64),
    ("decode", 8, 1, 384, 36, 36, 64, 64, 65),
    # splits 1-3 see no key: q_offset 5 masks keys 6.. causally
    ("decode masked splits", 2, 1, 256, 8, 2, 64, 5, 200),
    ("decode long cache", 2, 1, 4096, 36, 36, 64, 4095, 4096),
    ("gqa decode group 4", 4, 1, 256, 16, 4, 64, 200, 201),
    ("decode hd16", 4, 1, 200, 8, 4, 16, 150, 151),
    ("decode hd32", 4, 1, 200, 8, 4, 32, 150, 151),
    ("decode hd128", 4, 1, 200, 8, 4, 128, 150, 151),
    ("prefill q_offset ragged", 2, 70, 256, 8, 4, 64, 100, 170),
    ("embed ragged", 16, 45, 45, 36, 36, 64, 0, 45),
    ("gqa", 2, 100, 128, 8, 2, 64, 0, 100),
    ("gqa decode", 4, 1, 96, 8, 2, 64, 60, 61),
    ("hd16", 2, 70, 70, 4, 2, 16, 0, 70),
    ("hd32", 2, 70, 96, 4, 4, 32, 0, 70),
    ("hd128", 2, 70, 70, 4, 4, 128, 0, 70),
]


def flash_variant(torch, q) -> str:
    """The launch-count key of the kernel the wrapper takes for ``q``."""
    from repro_torch.kernels import flash_attention as kf

    if q.dtype == torch.float32:
        return kf.VARIANTS["fma"]
    return kf.VARIANTS["split_kv" if q.shape[1] == 1 else "mma"]


def flash_check(torch, label, q, k, v, **kw) -> tuple:
    """One wrapper call against the plain version (float32 within 2e-3,
    bf16 within 2e-2), through the kernel its dtype and Tq select; a
    split-KV call also against the float32 mirror of its arithmetic.
    Returns (output, max |error|)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as kf

    before = dict(kbuild.LAUNCHES)
    got = kf.flash_attention(q, k, v, **kw)
    variant = flash_variant(torch, q)
    for key in ("flash_attention", variant):
        if kbuild.LAUNCHES[key] != before.get(key, 0) + 1:
            raise AssertionError(f"flash_attention {label} did not launch "
                                 f"{variant} once")
    want = kf.flash_attention_plain(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    if q.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=2e-3, atol=2e-3)
    else:
        ok = err <= 2e-2
    if variant == kf.VARIANTS["split_kv"]:
        mirror = kf.flash_decode_split_plain(q, k, v, **kw)
        ok = ok and float((got.float() - mirror.float()).abs().max()) <= 2e-2
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {label} {q.dtype} differs by "
                             f"{err}")
    return got, err


def flash_kernels(torch) -> dict:
    """``flash_attention`` against its plain version (float32 within 2e-3,
    bf16 within 2e-2) at the RAG path's shapes, split boundaries, GQA,
    other head widths and strided cache slices, each call through the
    kernel its dtype and Tq select; the numbers at the three main shapes
    in bf16 (the tensor-core kernel at embed and prefill, the split-KV
    decode) and the CUDA-core kernel's at embed in float32, with
    ``scaled_dot_product_attention`` on the same inputs as the library
    call."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import flash_attention as kf

    g = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for label, b, tq, tk, h, kvh, hd, q_offset, valid in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, tq, h, hd), generator=g, device="cuda",
                            dtype=dtype)
            k = torch.randn((b, tk, kvh, hd), generator=g, device="cuda",
                            dtype=dtype)
            v = torch.randn((b, tk, kvh, hd), generator=g, device="cuda",
                            dtype=dtype)
            kw = dict(causal=True, q_offset=q_offset, kv_valid_len=valid)
            got, err = flash_check(torch, label, q, k, v, **kw)
            variant = flash_variant(torch, q)
            log(f"  flash_attention {label} B={b} Tq={tq} Tk={tk} H={h} "
                f"K={kvh} hd={hd} q_offset={q_offset} kv_valid={valid} "
                f"{str(dtype)[6:]} ({variant}): max |err| {err:.2e}")
            main = (label in ("embed", "prefill") and q_offset == 0) or (
                label == "decode" and q_offset == 351)
            if not main or (dtype == torch.float32 and label != "embed"):
                continue
            # the library call: SDPA on (B, H, T, hd) views of the same
            # tensors, over the visible keys (q_offset 0 is top-left causal)
            qt = q.transpose(1, 2)
            kt, vt = k[:, :valid].transpose(1, 2), v[:, :valid].transpose(1, 2)
            lib = partial(sdpa, qt, kt, vt, is_causal=label != "decode")
            lib_err = float((lib().transpose(1, 2).float()
                             - got.float()).abs().max())
            if lib_err > 2e-2:
                raise AssertionError(f"SDPA disagrees with flash_attention "
                                     f"at {label} by {lib_err}")
            b_ms, b_by = flash_bound(b, tq, h, kvh, hd, True, q_offset, valid,
                                     q.element_size())
            key = variant if label != "prefill" else f"{variant}_prefill"
            out[key] = {
                "name": variant, "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:28",
                "max_abs_err": err,
                "fns": (partial(kf.flash_attention, q, k, v, **kw),
                        partial(kf.flash_attention_plain, q, k, v, **kw),
                        lib),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": [label, b, tq, tk, h, hd, q_offset, valid,
                          str(dtype)[6:]],
                # prefill and the float32 kernel (no served call takes it)
                # are logged, not in the kernels line
                "log_only": label == "prefill" or dtype == torch.float32,
            }
    flash_strided(torch, g)
    return out


def flash_strided(torch, g) -> None:
    """bf16 K/V read through strides: a layer's slice of the stacked cache
    (``init_caches``' (layers, B, S, K, hd)) and the K half of a fused
    (B, S, 2, K, hd) buffer, in decode and prefill; and the 16-byte rule:
    a K one element off its alignment raises."""
    from repro_torch.kernels import flash_attention as kf

    stack = torch.randn((3, 4, 384, 8, 64), generator=g, device="cuda",
                        dtype=torch.bfloat16)
    fused = torch.randn((4, 384, 2, 8, 64), generator=g, device="cuda",
                        dtype=torch.bfloat16)
    for name, k, v in (("stacked cache slice", stack[1], stack[2]),
                       ("fused K/V halves", fused[:, :, 0], fused[:, :, 1])):
        for tq, q_offset in ((1, 200), (70, 130)):
            q = torch.randn((4, tq, 16, 64), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            _, err = flash_check(torch, name, q, k, v, q_offset=q_offset,
                                 kv_valid_len=q_offset + tq)
            log(f"  flash_attention {name} strides {k.stride()} Tq={tq} "
                f"q_offset={q_offset}: max |err| {err:.2e}")
    flat = torch.zeros(4 * 384 * 8 * 64 + 1, device="cuda",
                       dtype=torch.bfloat16)
    k = flat[1:].view(4, 384, 8, 64)
    try:
        kf.flash_attention(torch.zeros((4, 1, 16, 64), device="cuda",
                                       dtype=torch.bfloat16), k, k,
                           q_offset=10, kv_valid_len=11)
    except ValueError as e:
        log(f"  flash_attention misaligned K raises: {e}")
    else:
        raise AssertionError("a misaligned K did not raise")


def check_library(name: str, result, kernel_out) -> None:
    """The library call computes the kernel's function: the same integers."""
    if not bool((result.round().int() == kernel_out).all()):
        raise AssertionError(f"the matmul yardstick of {name} disagrees")


def phase_times(torch, kernels: dict) -> None:
    """Time each kernel and its plain version on the inputs phase 2 kept
    (the main path's shapes)."""
    for rec in kernels.values():
        kernel, plain, library = rec.pop("fns")
        rec["ms"], rec["stream_ms"] = time_ms(torch, kernel)
        rec["plain_ms"], rec["plain_stream_ms"] = time_ms(torch, plain,
                                                          reps=3)
        if rec.pop("library_gathered_late", False):
            # the earlier records' levels are freed by now
            library = library()
        rec["library_ms"] = time_ms(torch, library)[0] if library else None
        if rec["name"] == "flash_attention_split_kv":
            rec["kernel_ms"] = kernel_times(torch, kernel)
        lib = (f", library (one PyTorch call) device "
               f"{rec['library_ms']:.4f} ms" if library else "")
        log(f"  {rec['name']} at {rec['shape']}: device {rec['ms']:.4f} ms "
            f"(stream-timed {rec['stream_ms']:.4f}), plain device "
            f"{rec['plain_ms']:.4f} ms (stream-timed "
            f"{rec['plain_stream_ms']:.4f}){lib}, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        for name, ms in rec.get("kernel_ms", {}).items():
            log(f"    of which {name[:70]}: device {ms:.4f} ms a call "
                "(torch.profiler; a kernel launched early by programmatic "
                "dependent launch counts its wait)")
        del kernel, plain, library      # free this record's inputs now
    log(f"  clocks right after: {clocks()}")


def kernel_times(torch, fn, reps: int = 20) -> dict:
    """Device ms a call of ``fn`` by CUDA kernel, from ``torch.profiler``
    over ``reps`` calls: how a call of several launches splits."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            out[e.key] = us / 1e3 / reps
    return out


def ids_match(a, b, scores_a, scores_b, tol: float = 1e-6) -> int:
    """Two (Q, k) reranked id lists agree where their scores separate them:
    a position may hold different ids only where the two scores there lie
    within ``tol`` (a tie that float rounding may break either way).
    Returns the number of rows with such a tie."""
    import numpy as np

    diff = a != b
    if (np.abs(scores_a[diff] - scores_b[diff]) > tol).any():
        bad = int(np.nonzero(diff.any(axis=1))[0][0])
        raise AssertionError(
            f"query {bad}: ids {a[bad].tolist()} vs {b[bad].tolist()}")
    return int(diff.any(axis=1).sum())


def phase_parity(torch) -> None:
    """The N = 4000 builds on the CPU and on the card must agree."""
    import dataclasses

    import numpy as np

    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset

    base, queries = make_dataset("cohere-surrogate", 4000, queries=100)
    params = BuildParams(m=16, ef_construction=64, prune_pool=64)
    parity_ivf(torch, base, queries,
               dataclasses.replace(params, ivf_candidates=True))
    built = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        idx = QuIVerIndex.build(base, params, device=dev)
        beam_ids, _ = idx.search(queries, k=10, ef=64, rerank=False)
        ids, scores = idx.search(queries, k=10, ef=64)
        built[dev] = (idx, beam_ids, ids, scores)
        log(f"  {dev}: build + search {time.perf_counter() - t0:.1f} s, "
            f"medoid {idx.medoid}")
    cpu, gpu = built["cpu"], built["cuda"]
    if not torch.equal(cpu[0].sigs.words, gpu[0].sigs.words.cpu()):
        raise AssertionError("signatures differ between CPU and card")
    if not torch.equal(cpu[0].adjacency, gpu[0].adjacency.cpu()):
        raise AssertionError("adjacency differs between CPU and card")
    if cpu[0].medoid != gpu[0].medoid:
        raise AssertionError("medoid differs between CPU and card")
    if not np.array_equal(cpu[1], gpu[1]):
        raise AssertionError("beam ids differ between CPU and card")
    if not np.allclose(cpu[3], gpu[3], rtol=1e-5, atol=1e-6):
        raise AssertionError("rerank scores differ between CPU and card")
    tied = ids_match(cpu[2], gpu[2], cpu[3], gpu[3])
    log(f"  signatures, adjacency, medoid and beam ids identical; reranked "
        f"ids identical up to {tied} rows of scores within 1e-6")
    parity_graph(cpu[0], gpu[0], "beam-built graph")
    parity_engine(torch, cpu[0], gpu[0], queries)
    parity_filter(torch, cpu[0], gpu[0], queries)
    c_mut, g_mut = parity_stream(torch, cpu[0], gpu[0], queries)
    parity_graph(c_mut, g_mut, "stream script's mutated graph")
    for name, want in (("sift-like", "float32"), ("cohere-surrogate", "bq2")):
        parity_auto(torch, name, want, params)
    parity_lm(torch)


def parity_filter(torch, cpu, gpu, queries) -> None:
    """The filter phase's labels and predicates on the N = 4000 graph, on
    the CPU and on the card, for the first 32 queries: equal entries and
    plans; identical ids and scores on the graph routes (searched with
    ``rerank=False``) and on the brute route without rerank; ids matched by
    ``ids_match`` on the reranked brute routes."""
    import dataclasses

    import numpy as np

    from repro_torch.plan import resolve_plan

    rng = np.random.default_rng(0)
    member = np.stack([rng.random(cpu.adjacency.shape[0]) < p
                       for p in FILTER_RATES], axis=1)
    rows = label_rows(member)
    for index in (cpu, gpu):
        index.attach_labels(rows, n_labels=len(FILTER_RATES))
        index.build_label_entries(min_count=32)
    if not np.array_equal(cpu.labels.entries, gpu.labels.entries):
        raise AssertionError(f"label entries differ: {cpu.labels.entries} "
                             f"vs {gpu.labels.entries}")
    routes, tied = [], 0
    queries = queries[:32]
    for name, pred, mask_of, kw, on_ivf in filter_searches():
        if on_ivf or pred is None:
            continue
        plans = [resolve_plan(index, k=10, ef=64, filter=pred, **kw)
                 for index in (cpu, gpu)]
        (c_plan, c_ctx), (g_plan, g_ctx) = plans
        if dataclasses.asdict(c_plan) != dataclasses.asdict(g_plan) \
                or c_ctx.start != g_ctx.start \
                or c_ctx.selectivity != g_ctx.selectivity:
            raise AssertionError(f"{name}: plans differ: {c_plan}, "
                                 f"{g_plan}")
        routes.append(f"{name}: {g_plan.route}")
        if g_plan.route == "graph":
            kw = {**kw, "rerank": False}
        (c_ids, c_sc), (g_ids, g_sc) = (
            index.search(queries, k=10, ef=64, filter=pred, **kw)
            for index in (cpu, gpu))
        if not mask_of(member)[g_ids[g_ids >= 0]].all():
            raise AssertionError(f"{name}: an id outside its predicate")
        if kw.get("rerank", True):
            tied += ids_match(c_ids, g_ids, c_sc, g_sc)
        elif not (np.array_equal(c_ids, g_ids)
                  and np.array_equal(c_sc, g_sc)):
            raise AssertionError(f"{name}: hot-path ids differ")
    log(f"  filters: entries {gpu.labels.entries.tolist()} equal; plans "
        f"equal ({'; '.join(routes)}); hot-path ids identical, reranked "
        f"brute ids identical up to {tied} rows of scores within 1e-6")


def stream_state(mut) -> dict:
    """A mutable index's state on the host, for exact comparison."""
    import dataclasses

    return {"words": mut.words.cpu(), "adjacency": mut.adjacency.cpu(),
            "deg": mut.deg.cpu(), "labels": mut.labels.words.cpu(),
            "live": mut.live, "allocated": mut.allocated,
            "free": mut._free, "medoid": mut.medoid,
            "generation": mut.generation,
            "stats": dataclasses.asdict(mut.stats),
            "probe_acc": mut.probe_acc}


def assert_same_stream_state(torch, a: dict, b: dict, what: str) -> None:
    import numpy as np

    for key, value in a.items():
        other = b[key]
        if isinstance(value, torch.Tensor):
            same = torch.equal(value, other)
        elif isinstance(value, np.ndarray):
            same = np.array_equal(value, other)
        else:
            same = value == other
        if not same:
            raise AssertionError(f"{what}: {key} differs")


def parity_stream(torch, cpu, gpu, queries) -> tuple:
    """The streaming mutation script on the N = 4000 graph (with the
    filter phase's labels), on the CPU and on the card: ``from_index``,
    insert 400 (seeded perturbed copies of rows, with labels), delete 300
    (the medoid among them), searches on the graph and brute routes,
    ``consolidate``, insert 300 into the reclaimed slots, ``freeze``.
    Identical words, adjacency, degrees, label words, masks, free list,
    medoid, statistics and hot-path ids after it, and identical frozen
    graphs; then a mutable archive saved on the card loads on the CPU.
    Returns the two mutated indexes (CPU, card)."""
    import numpy as np

    from repro_torch.filter import Any
    from repro_torch.stream import MutableQuIVerIndex

    n, dim = cpu.vectors.shape
    rng = np.random.default_rng(5)
    fresh = cpu.vectors.numpy()[rng.choice(n, 700, replace=False)] \
        + 0.05 * rng.standard_normal((700, dim)).astype(np.float32)
    new_labels = label_rows(np.stack([rng.random(700) < p
                                      for p in FILTER_RATES], axis=1))
    dead = np.r_[cpu.medoid, rng.choice(n, 299, replace=False)]
    runs = {}
    for name, index in (("cpu", cpu), ("card", gpu)):
        t0 = time.perf_counter()
        mut = MutableQuIVerIndex.from_index(index)
        ids = []

        def search(target=mut, **kw):
            ids.append(target.search(queries[:32], k=10, ef=64,
                                     rerank=False, **kw)[0])

        mut.insert(fresh[:400], labels=new_labels[:400])
        mut.delete(dead)
        for pred in (None, 3, 5):           # label 3: graph, 5: brute
            search(filter=pred)
        report = mut.consolidate()
        search()
        reused = mut.insert(fresh[400:], labels=new_labels[400:])
        search(filter=Any(0, 1))
        frozen = mut.freeze()
        search(target=frozen)
        runs[name] = (mut, frozen, ids, report, reused)
        log(f"  {name}: stream script {time.perf_counter() - t0:.1f} s, "
            f"consolidate {report}, medoid {mut.medoid}")
    (c_mut, c_frozen, c_ids, c_rep, c_reused), \
        (g_mut, g_frozen, g_ids, g_rep, g_reused) = runs["cpu"], runs["card"]
    assert_same_stream_state(torch, stream_state(c_mut), stream_state(g_mut),
                             "stream script, CPU against card")
    if c_rep != g_rep or not np.array_equal(c_reused, g_reused):
        raise AssertionError("consolidate or slot reuse differs")
    if not np.isin(g_reused, dead).all():
        raise AssertionError("the insert did not reuse reclaimed slots")
    if not all(np.array_equal(a, b) for a, b in zip(c_ids, g_ids)):
        raise AssertionError("stream search ids differ")
    if not (torch.equal(c_frozen.adjacency, g_frozen.adjacency.cpu())
            and c_frozen.medoid == g_frozen.medoid):
        raise AssertionError("frozen graphs differ")
    path = ROOT / "build" / "smoke" / "stream.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    g_mut.save(str(path))
    back = MutableQuIVerIndex.load(str(path), "cpu")
    assert_same_stream_state(torch, stream_state(back),
                             {**stream_state(c_mut),
                              "stats": stream_state(back)["stats"]},
                             "card archive loaded on the CPU")
    log(f"  stream: state, {len(g_ids)} searches' ids and the frozen graph "
        "identical; the card's archive loads on the CPU identically")
    return c_mut, g_mut


# -- the serving engine: request scripts, shared by phase 3 and the engine
# phase -------------------------------------------------------------------


class StepClock:
    """A scripted clock: each read returns the time, then moves it on by
    ``step`` seconds, so two engines driven by the same script see the
    same times (deadlines, latencies, the EWMA that degrades requests)."""

    def __init__(self, step: float):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        now = self.t
        self.t += self.step
        return now


def engine_requests(n_rag: int, n_batch: int, batch_size: int,
                    n_capped: int, deadlines=(None, 1.0)) -> list:
    """The three tenants' requests in submission order, as (tenant, first
    row, rows, submit kwargs): ``rag``'s singletons, then ``batch``'s
    requests of ``batch_size`` (deadlines cycling through ``deadlines``,
    in ms), then ``capped``'s singletons, on consecutive query rows."""
    reqs, row = [], 0
    for _ in range(n_rag):
        reqs.append(("rag", row, 1, {}))
        row += 1
    for i in range(n_batch):
        ms = deadlines[i % len(deadlines)]
        reqs.append(("batch", row, batch_size,
                     {} if ms is None else {"deadline_ms": ms}))
        row += batch_size
    for _ in range(n_capped):
        reqs.append(("capped", row, 1, {}))
        row += 1
    return reqs


def drive_engine(engine, queries, reqs, every: int) -> list:
    """Submit ``reqs`` in order, pumping a window every ``every``
    requests and once at the end; returns the ticket ids."""
    tickets = []
    for i, (tenant, row, count, kw) in enumerate(reqs):
        q = queries[row] if count == 1 else queries[row:row + count]
        tickets.append(engine.submit(q, tenant=tenant, **kw))
        if (i + 1) % every == 0:
            engine.pump()
    engine.pump()
    return tickets


def tap_shadow(sampler) -> tuple[list, list]:
    """Record what a ``ShadowSampler`` is offered (queries, served ids)
    and what it drains, in order; returns the two lists."""
    import numpy as np

    offers, drained = [], []
    offer, drain = sampler.offer, sampler.drain

    def tapped_offer(queries, served_ids, **kw):
        offers.append((np.atleast_2d(np.array(queries, np.float32)),
                       np.atleast_2d(np.array(served_ids))))
        return offer(queries, served_ids, **kw)

    def tapped_drain(max_rows=None):
        out = drain(max_rows)
        drained.extend(out)
        return out

    sampler.offer, sampler.drain = tapped_offer, tapped_drain
    return offers, drained


def shadow_expected(offers, row_of, truth, rate: int, k: int = 10) -> list:
    """The recall of every offered row that hashes into the shadow lane,
    in offer order, against ``truth`` (exact ids by query row; ``row_of``
    maps a query's float32 bytes to its row)."""
    from repro_torch.obs.quality import should_sample

    want = []
    for queries, served in offers:
        for q, ids in zip(queries, served):
            if should_sample(q, rate):
                hits = set(ids[:k].tolist()) & set(
                    truth[row_of[q.tobytes()]].tolist())
                want.append(len(hits) / k)
    return want


def ticket_record(engine, t) -> tuple:
    tk = engine.ticket(t)
    return (tk.status, tk.degraded, tk.latency,
            tk.plan.signature() if tk.plan is not None else None)


def parity_engine(torch, cpu, gpu, queries) -> None:
    """One request script (phase 3's 100 queries: ``rag`` 40 singletons,
    ``batch`` 6 requests of 5 with deadlines of none, 1 and 30 ms, and
    ``capped`` 30 singletons at ``set_quota(qps=50, burst=8)``; a window
    every 16 requests; shadow lane at rate 4) through a ``QueryEngine``
    on each device under the same scripted clock (2 ms a read, latency
    slack 10, so deadlines degrade and drop).  The tickets' statuses,
    degrade rungs, latencies, plan signatures and ids identical, scores
    within 1e-6; the shadow lane's sampled rows and drained recalls
    identical, and each recall the one exact search gives the row."""
    import numpy as np

    from repro_torch.core.baselines import flat_search
    from repro_torch.obs import MetricsRegistry, ObsHub
    from repro_torch.serve.engine import QueryEngine

    reqs = engine_requests(40, 6, 5, 30, deadlines=(None, 1.0, 30.0))
    runs = {}
    for name, index in (("cpu", cpu), ("card", gpu)):
        t0 = time.perf_counter()
        engine = QueryEngine(index, clock=StepClock(0.002),
                             latency_slack=10.0,
                             obs=ObsHub(MetricsRegistry()),
                             shadow={"rate": 4})
        engine.set_quota("rag", qps=1e6, recall_slo=0.75)
        engine.set_quota("capped", qps=50.0, burst=8)
        offers, drained = tap_shadow(engine.shadow)
        tickets = drive_engine(engine, queries, reqs, every=16)
        runs[name] = (engine, tickets, offers, drained)
        log(f"  {name}: engine script {time.perf_counter() - t0:.2f} s")
    (c_eng, c_ts, c_offers, c_drained), (g_eng, g_ts, g_offers,
                                         g_drained) = runs["cpu"], \
        runs["card"]
    statuses = {}
    for t in g_ts:
        c_rec, g_rec = ticket_record(c_eng, t), ticket_record(g_eng, t)
        if c_rec != g_rec:
            raise AssertionError(f"engine ticket {t}: {c_rec} vs {g_rec}")
        (c_ids, c_sc), (g_ids, g_sc) = c_eng.poll(t), g_eng.poll(t)
        finite = np.isfinite(c_sc)
        if not (np.array_equal(c_ids, g_ids)
                and np.array_equal(finite, np.isfinite(g_sc))
                and np.abs(c_sc[finite] - g_sc[finite]).max(initial=0.0)
                <= 1e-6):
            raise AssertionError(f"engine ticket {t}: results differ")
        statuses[g_rec[0]] = statuses.get(g_rec[0], 0) + 1
    degraded = sum(g_eng.ticket(t).degraded > 0 for t in g_ts)
    sampled = [[q.tobytes() for q in qs] for qs, _ in g_offers]
    if sampled != [[q.tobytes() for q in qs] for qs, _ in c_offers] \
            or g_eng.shadow.sampled != c_eng.shadow.sampled:
        raise AssertionError("the shadow lane sampled other rows")
    g_rec = [d["recall"] for d in g_drained]
    if g_rec != [d["recall"] for d in c_drained]:
        raise AssertionError("drained shadow recalls differ")
    truth, _ = flat_search(cpu.vectors, queries, 10, device="cpu")
    row_of = {q.tobytes(): i for i, q in enumerate(
        np.asarray(queries, np.float32))}
    if g_rec != shadow_expected(g_offers, row_of, truth, 4):
        raise AssertionError("a drained recall is not its row's exact "
                             "recall")
    log(f"  engine: {len(g_ts)} tickets identical ({statuses}, {degraded} "
        f"degraded); shadow lane {g_eng.shadow.sampled} rows sampled, "
        f"{len(g_rec)} recalls drained, identical and exact (mean "
        f"{np.mean(g_rec):.4f})")


# the graph report's fields held exactly between two devices (the edge
# agreement is held within 2 / (S k): its float32 cosine sums in each
# device's order)
GRAPH_EXACT = ("n_live", "n_allocated", "degree_bound", "out_degree_mean",
               "in_degree_mean", "saturation", "reciprocity",
               "n_unreachable", "unreachable_frac", "hop_p50", "hop_p99",
               "hop_max", "tombstone_density", "n_sampled", "agreement_k",
               "seed", "out_degree_hist", "in_degree_hist")


def parity_graph(cpu, gpu, what: str) -> None:
    """``graph_report()`` (S = 256, k = 8) of one graph on the CPU and on
    the card: integer and host-side fields and the verdict identical, the
    edge agreement within 2 / (S k)."""
    from repro_torch.obs import MetricsRegistry

    c = cpu.graph_report(registry=MetricsRegistry())
    g = gpu.graph_report(registry=MetricsRegistry())
    for name in GRAPH_EXACT:
        if getattr(c, name) != getattr(g, name):
            raise AssertionError(f"{what}: graph report {name} differs: "
                                 f"{getattr(c, name)} vs {getattr(g, name)}")
    tol = 2 / (c.n_sampled * c.agreement_k)
    if c.verdict != g.verdict \
            or not abs(c.edge_agreement - g.edge_agreement) <= tol:
        raise AssertionError(f"{what}: {c.summary()} vs {g.summary()}")
    log(f"  graph X-ray of the {what}: identical ({g.summary()}; agreement "
        f"{c.edge_agreement:.4f} / {g.edge_agreement:.4f}, tolerance "
        f"{tol:.5f})")


def parity_lm(torch) -> None:
    """``minicpm-2b`` at full width and 2 layers, bf16, drawn on the CPU and
    copied to the card: 2 prompts of 48 tokens, prefill and 8 greedy decode
    steps on each (the card fed the CPU's tokens, so every step compares
    like with like); every logit within 0.1 (bf16 products round at other
    places on the two devices), equal argmax where the CPU's top-2 gap
    exceeds 0.2, and mean-pooled embeddings at cosine >= 0.999."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serve.engine import mean_pool_embedder

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=2)
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    cpu = bundle.init(0, device="cpu")
    gpu = DecoderLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    log(f"  minicpm-2b x 2 layers drawn on the CPU and copied: "
        f"{time.perf_counter() - t0:.1f} s")
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

    t0 = time.perf_counter()
    want = run(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    kbuild.reset_launches()
    t0 = time.perf_counter()
    got = run(gpu, "cuda", feed=[w.argmax(-1) for w in want[:-1]])
    t_gpu = time.perf_counter() - t0
    if kbuild.LAUNCHES["flash_attention"] != 2 * 9:
        raise AssertionError(f"flash_attention launched "
                             f"{kbuild.LAUNCHES['flash_attention']} times, "
                             "not 2 layers x 9 calls")
    worst, compared = 0.0, 0
    for step, (w, gt) in enumerate(zip(want, got)):
        real = w > -1e29
        worst = max(worst, float((gt - w).abs()[real].max()))
        top2 = w.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 0.2
        compared += int(clear.sum())
        if not torch.equal(gt.argmax(-1)[clear], w.argmax(-1)[clear]):
            raise AssertionError(f"greedy token differs at step {step}")
    if worst > 0.1:
        raise AssertionError(f"logits differ by {worst} > 0.1")
    e_cpu = mean_pool_embedder(bundle, cpu)(prompts)
    e_gpu = mean_pool_embedder(bundle, gpu)(prompts).cpu()
    cos = float(torch.nn.functional.cosine_similarity(e_cpu, e_gpu).min())
    if cos < 0.999:
        raise AssertionError(f"embeddings at cosine {cos} < 0.999")
    log(f"  minicpm-2b x 2 layers, 2 x 48 tokens, prefill + 8 decode steps: "
        f"CPU {t_cpu:.1f} s, card {t_gpu:.1f} s; max |logit diff| "
        f"{worst:.4f}; greedy tokens equal at all {compared} of 18 "
        f"(row, step) pairs with a top-2 gap > 0.2; embedding cosine "
        f">= {cos:.6f}")


def parity_auto(torch, name: str, want: str, params) -> None:
    """``build(nav="auto")`` on the CPU and on the card: the same report
    verdict and policy, and ids matched by ``ids_match``."""
    import dataclasses

    from repro_torch.core.index import QuIVerIndex
    from repro_torch.data.datasets import make_dataset

    base, queries = make_dataset(name, 4000, queries=100)
    built = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        idx = QuIVerIndex.build(base, params, nav="auto", device=dev)
        ids, scores = idx.search(queries, k=10, ef=64)
        built[dev] = (idx, ids, scores)
        log(f"  {dev}: {name} auto build + search "
            f"{time.perf_counter() - t0:.1f} s: {idx.report.summary()} -> "
            f"{idx.policy.describe()}")
    (cpu, c_ids, c_scores), (gpu, g_ids, g_scores) = \
        built["cpu"], built["cuda"]
    if dataclasses.asdict(cpu.policy) != dataclasses.asdict(gpu.policy):
        raise AssertionError(f"{name}: policies differ: "
                             f"{cpu.policy} vs {gpu.policy}")
    if gpu.policy.nav != want or gpu.metric_kind != want:
        raise AssertionError(f"{name}: auto chose {gpu.policy.nav}, "
                             f"expected {want}")
    tied = ids_match(c_ids, g_ids, c_scores, g_scores)
    same_graph = torch.equal(cpu.adjacency, gpu.adjacency.cpu())
    log(f"  {name}: policies equal ({gpu.policy.describe()}); ids identical "
        f"up to {tied} rows of scores within 1e-6; adjacency identical: "
        f"{same_graph}")


def parity_ivf(torch, base, queries, params) -> None:
    """The IVF-seeded build and ``nav="ivf"`` search on the CPU and on the
    card: identical partition, adjacency, medoid and candidate ids."""
    import numpy as np

    from repro_torch.core.index import QuIVerIndex

    built = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        idx = QuIVerIndex.build(base, params, device=dev)
        ids, _ = idx.search(queries, k=10, ef=128, nav="ivf", rerank=False)
        built[dev] = (idx, ids)
        log(f"  {dev}: IVF-seeded build + nav=ivf search "
            f"{time.perf_counter() - t0:.1f} s, {idx.ivf.n_lists} lists, "
            f"cap {idx.ivf.cap}")
    (cpu, c_ids), (gpu, g_ids) = built["cpu"], built["cuda"]
    for field in ("cent_words", "list_ids"):
        if not torch.equal(getattr(cpu.ivf, field),
                           getattr(gpu.ivf, field).cpu()):
            raise AssertionError(f"partition {field} differs")
    for field in ("assign", "member_ids", "offsets", "cent_ids"):
        if not np.array_equal(getattr(cpu.ivf, field),
                              getattr(gpu.ivf, field)):
            raise AssertionError(f"partition {field} differs")
    if not torch.equal(cpu.adjacency, gpu.adjacency.cpu()):
        raise AssertionError("IVF-seeded adjacency differs")
    if cpu.medoid != gpu.medoid:
        raise AssertionError("IVF-seeded medoid differs")
    if not np.array_equal(c_ids, g_ids):
        raise AssertionError("nav=ivf candidate ids differ")
    log("  IVF: partition, adjacency, medoid and nav=ivf ids identical")


def pool_sizes(launches: dict, prefix: str = "bq_pairwise") -> str:
    """``prefix`` launches by pool size C (the ``bq_pairwise`` and
    ``hamming_pairwise`` wrappers count each call under ``<prefix>_c<C>``):
    C = 128 are a build chunk's prune pools, C = 72 consolidation's."""
    sizes = {int(key[len(prefix) + 2:]): n
             for key, n in launches.items()
             if key.startswith(prefix + "_c")}
    return ", ".join(f"C={c}: {sizes[c]}" for c in sorted(sizes)) or "none"


def phase_main(torch) -> dict:
    """The main path at deployment size; returns launch counts and stats."""
    import numpy as np

    from repro_torch.core.baselines import flat_search, recall_at_k
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import build as kbuild

    n, n_queries = 100_000, 1000
    base, queries = make_dataset("cohere-surrogate", n, queries=n_queries)
    truth, _ = flat_search(base, queries, 10, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kbuild.reset_launches()
    t0 = time.perf_counter()
    index = QuIVerIndex.build(base, BuildParams(), device="cuda")
    torch.cuda.synchronize()
    build_wall = time.perf_counter() - t0
    stats = index.build_stats
    t0 = time.perf_counter()
    ids, scores = index.search(queries, k=10, ef=64)
    search_s = time.perf_counter() - t0
    save_dir = ROOT / "build" / "smoke"
    save_dir.mkdir(parents=True, exist_ok=True)
    path = save_dir / "index.npz"
    index.save(str(path))
    loaded = QuIVerIndex.load(str(path), device="cuda")
    ids2, scores2 = loaded.search(queries, k=10, ef=64)
    torch.cuda.synchronize()
    launches = dict(kbuild.LAUNCHES)

    recall = recall_at_k(ids, truth)
    log(f"  encode (normalize + binarize) {build_wall - stats.seconds:.3f} s, "
        f"build {stats.seconds:.1f} s ({stats.chunks} chunks, mean hops "
        f"{stats.mean_hops:.1f}, {stats.consolidations} consolidations)")
    log(f"  search {n_queries} queries at k=10 ef=64: {search_s:.3f} s, "
        f"{n_queries / search_s:.1f} QPS, recall@10 {recall:.4f}")
    log(f"  memory_breakdown {json.dumps(index.memory_breakdown())}")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log(f"  launches on the main path: {launches}")
    log(f"  bq_pairwise launches by pool size: {pool_sizes(launches)}")
    if ids.shape != (n_queries, 10) or not np.isfinite(scores).all():
        raise AssertionError("search output malformed")
    if ids.min() < 0 or ids.max() >= n:
        raise AssertionError("search returned ids out of range")
    if recall < 0.80:
        raise AssertionError(f"recall@10 {recall:.4f} is below 0.80")
    if not (np.array_equal(ids, ids2) and np.array_equal(scores, scores2)):
        raise AssertionError("save/load changed the search results")
    for name in ("binarize", "bq_dist_rows", "bq_pairwise"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return {"launches": launches, "recall": recall,
            "build_s": stats.seconds, "qps": n_queries / search_s,
            "index": index, "data": (base, queries, truth), "ids": ids,
            "scores": scores}


def phase_ivf(torch) -> dict:
    """The IVF path at deployment size; returns its launch counts."""
    import numpy as np

    from repro_torch.core.baselines import flat_search, recall_at_k
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset
    from repro_torch.ivf import build_partition
    from repro_torch.kernels import build as kbuild

    n, n_queries = 100_000, 1000
    base, queries = make_dataset("cohere-surrogate", n, queries=n_queries)
    truth, _ = flat_search(base, queries, 10, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kbuild.reset_launches()
    t0 = time.perf_counter()
    index = QuIVerIndex.build(base, BuildParams(ivf_candidates=True),
                              device="cuda")
    torch.cuda.synchronize()
    build_wall = time.perf_counter() - t0
    stats, part = index.build_stats, index.ivf
    wide = -(-3 * part.n_lists // 4)
    runs = []
    for label, kw in (("bq2 ef=64", {"nav": "bq2", "ef": 64}),
                      (f"ivf ef=128 probes={part.default_probes} (default)",
                       {"nav": "ivf", "ef": 128}),
                      (f"ivf ef=128 probes={wide}",
                       {"nav": "ivf", "ef": 128, "probes": wide})):
        t0 = time.perf_counter()
        ids, scores = index.search(queries, k=10, **kw)
        secs = time.perf_counter() - t0
        recall = recall_at_k(ids, truth)
        runs.append((ids, scores, recall))
        log(f"  search {n_queries} queries nav={label}: {secs:.3f} s, "
            f"{n_queries / secs:.1f} QPS, recall@10 {recall:.4f}")
        if ids.shape != (n_queries, 10) or not np.isfinite(scores).all():
            raise AssertionError(f"nav={label}: search output malformed")
        if ids.min() < 0 or ids.max() >= n:
            raise AssertionError(f"nav={label}: ids out of range")
    save_dir = ROOT / "build" / "smoke"
    save_dir.mkdir(parents=True, exist_ok=True)
    path = save_dir / "ivf_index.npz"
    index.save(str(path))
    loaded = QuIVerIndex.load(str(path), device="cuda")
    ids2, scores2 = loaded.search(queries, k=10, ef=128, nav="ivf")
    torch.cuda.synchronize()
    launches = dict(kbuild.LAUNCHES)

    # the partition alone, timed again on the index's signatures (after
    # the launches were read): the same seed gives the same lists
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = build_partition(index.sigs,
                            n_lists=index.params.ivf_lists or None,
                            seed=index.params.seed)
    torch.cuda.synchronize()
    partition_s = time.perf_counter() - t0
    if not (torch.equal(again.cent_words, part.cent_words)
            and np.array_equal(again.member_ids, part.member_ids)):
        raise AssertionError("the partition is not deterministic")
    log(f"  encode + partition {build_wall - stats.seconds:.3f} s, partition "
        f"alone {partition_s:.3f} s ({part.n_lists} lists, cap {part.cap}, "
        f"build probes {part.build_probes}), linking {stats.seconds:.1f} s "
        f"({stats.chunks} chunks, {stats.consolidations} consolidations)")
    log(f"  hot_ivf_bytes {index.memory_breakdown()['hot_ivf_bytes']}, "
        f"memory_breakdown {json.dumps(index.memory_breakdown())}")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log(f"  launches on the IVF path: {launches}")
    log(f"  bq_pairwise launches by pool size: {pool_sizes(launches)}")
    (_, _, r_graph), (default_ids, default_scores, _), (_, _, r_wide) = runs
    if r_graph < 0.80:
        raise AssertionError(f"IVF-seeded graph recall@10 {r_graph:.4f} is "
                             "below 0.80")
    if r_wide < r_graph - 0.02:
        raise AssertionError(f"widened nav=ivf recall@10 {r_wide:.4f} is "
                             f"below the graph's {r_graph:.4f} - 0.02")
    if not (np.array_equal(default_ids, ids2)
            and np.array_equal(default_scores, scores2)):
        raise AssertionError("save/load changed the nav=ivf results")
    for name in ("binarize", "bq_dist_rows", "bq_pairwise", "list_scan"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"{name} never launched on the IVF path")
    return {"launches": launches, "index": index,
            "ivf_recall": runs[1][2]}


def smoke_hub():
    """An ``ObsHub`` over a registry of its own, for a plan cache's
    ``obs``: its counters belong to one phase."""
    from repro_torch.obs import MetricsRegistry, ObsHub

    return ObsHub(MetricsRegistry())


def escalated(hub) -> float:
    """Queries escalated so far under ``hub`` (the plan cache's
    ``quiver_escalated_queries_total``)."""
    counter = hub.registry.counter("quiver_escalated_queries_total",
                                   labels=("plan",))
    return float(sum(slot[0] for slot in counter.series().values()))


def timed_search(index, queries, truth, label: str, **kw):
    """One search of every query; logs and returns (ids, recall)."""
    import numpy as np

    from repro_torch.core.baselines import recall_at_k

    t0 = time.perf_counter()
    ids, scores = index.search(queries, k=10, ef=64, **kw)
    secs = time.perf_counter() - t0
    recall = recall_at_k(ids, truth)
    log(f"  search {len(queries)} queries {label}: {secs:.3f} s, "
        f"{len(queries) / secs:.1f} QPS, recall@10 {recall:.4f}")
    if ids.shape != (len(queries), 10) or not np.isfinite(scores).all():
        raise AssertionError(f"{label}: search output malformed")
    if ids.min() < 0 or ids.max() >= index.adjacency.shape[0]:
        raise AssertionError(f"{label}: ids out of range")
    return ids, recall


# phase 6's bq1 build runs over the first 50 000 rows on every host: the
# smoke's one fixed cut of depth (its searches and probes stay at 100 000)
LADDER_BQ1_N = 50_000


def phase_ladder(torch, main: dict | None) -> dict:
    """The metric ladder at deployment size; returns its launch counts."""
    import dataclasses

    import numpy as np

    from repro_torch.core.baselines import flat_search
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import build as kbuild
    from repro_torch.probe import probe_corpus, select_policy

    n, n_queries = 100_000, 1000
    if main is not None:
        base, queries, truth = main["data"]
        graph = main["index"]
    else:
        base, queries = make_dataset("cohere-surrogate", n, queries=n_queries)
        truth, _ = flat_search(base, queries, 10, device="cuda")
        log("  (phase 4 did not run: building its bq2 graph first)")
        graph = QuIVerIndex.build(base, BuildParams(), device="cuda")
    torch.cuda.synchronize()

    # the bq1 graph's truth: exact search over its rows
    truth_bq1, _ = flat_search(base[:LADDER_BQ1_N], queries, 10,
                               device="cuda")
    kbuild.reset_launches()
    # 1. the bits ablation at full width: a bq1 graph, over the first
    # LADDER_BQ1_N rows (the one cut of depth, the same on every host)
    t0 = time.perf_counter()
    bq1 = QuIVerIndex.build(base[:LADDER_BQ1_N], BuildParams(), metric="bq1",
                            device="cuda")
    torch.cuda.synchronize()
    build_wall = time.perf_counter() - t0
    stats = bq1.build_stats
    log(f"  bq1 build N={LADDER_BQ1_N} {stats.seconds:.1f} s (wall "
        f"{build_wall:.1f} s; {stats.chunks} chunks, mean hops "
        f"{stats.mean_hops:.1f}, {stats.consolidations} consolidations)")
    _, r_bq1 = timed_search(bq1, queries, truth_bq1,
                            'nav="bq1" on the bq1 graph', nav="bq1")
    bq1_launches = {k: v for k, v in kbuild.LAUNCHES.items()
                    if k.startswith("hamming")}
    log(f"  hamming launches of the bq1 build + search: {bq1_launches}")
    log(f"  hamming_pairwise launches by pool size: "
        f"{pool_sizes(bq1_launches, 'hamming_pairwise')}")
    del bq1

    # 2. every nav kind on the bq2 graph, and adaptive escalation
    recalls = {}
    for nav in ("bq2", "bq1", "adc", "float32"):
        _, recalls[nav] = timed_search(graph, queries, truth,
                                       f'nav="{nav}" on the bq2 graph',
                                       nav=nav)
    # the escalation counter lives on the plan cache's hub
    graph.plans.obs = hub = smoke_hub()
    _, r_adaptive = timed_search(graph, queries, truth,
                                 'nav="bq2" adaptive=True on the bq2 graph',
                                 nav="bq2", adaptive=True)
    graph.plans.obs = None
    n_escalated = escalated(hub)
    log(f"  adaptive: {int(n_escalated)} of {n_queries} queries escalated "
        f"({n_escalated / n_queries:.1%}) at the default margin 0.15, ef x4")

    # 3. the probe, on the card and on the CPU
    verdicts = {}
    for name in ("cohere-surrogate", "sift-like", "random-sphere"):
        data = base if name == "cohere-surrogate" \
            else make_dataset(name, n, queries=0)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = probe_corpus(data, sample=1024, device="cuda")
        secs = time.perf_counter() - t0
        cpu = probe_corpus(data, sample=1024, device="cpu")
        policy, cpu_policy = select_policy(report), select_policy(cpu)
        exact = {f.name: getattr(report, f.name) == getattr(cpu, f.name)
                 for f in dataclasses.fields(report)}
        log(f"  probe {name} N={n} sample 1024: {secs:.3f} s on the card; "
            f"{report.summary()} margin_p30={report.margin_p30:.4f} "
            f"cluster={report.cluster_concentration:.4f} -> "
            f"{policy.describe()}; fields equal to the CPU port's: "
            f"{sorted(k for k, v in exact.items() if v)}; differing: "
            f"{ {k: (getattr(report, k), getattr(cpu, k)) for k, v in exact.items() if not v} }")
        if report.verdict != cpu.verdict or policy != cpu_policy:
            raise AssertionError(f"probe {name}: card and CPU disagree: "
                                 f"{report.summary()} vs {cpu.summary()}")
        verdicts[name] = report.verdict
    torch.cuda.synchronize()
    launches = dict(kbuild.LAUNCHES)
    log(f"  launches on the ladder path: {launches}")

    if r_bq1 < 0.50:
        raise AssertionError(f"bq1 recall@10 {r_bq1:.4f} is below 0.50")
    for nav, r in recalls.items():
        if r < 0.50:
            raise AssertionError(f"nav={nav} recall@10 {r:.4f} is below 0.50")
    if main is not None and recalls["bq2"] != main["recall"]:
        raise AssertionError("nav=bq2 on the main graph changed its recall")
    if r_adaptive < recalls["bq2"] - 0.005:
        raise AssertionError(f"adaptive recall@10 {r_adaptive:.4f} is below "
                             f"plain bq2's {recalls['bq2']:.4f} - 0.005")
    if verdicts != {"cohere-surrogate": "green", "sift-like": "red",
                    "random-sphere": "red"}:
        raise AssertionError(f"probe verdicts {verdicts}")
    for name in ("binarize", "bq_dist_rows", "hamming_dist_rows",
                 "hamming_pairwise", "list_scan"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"{name} never launched on the ladder path")
    return {"launches": launches}


# the filter phase's catalogue: 8 labels, each row's membership drawn
# independently at these rates (a long tail of rare facets; label 3 sits at
# 0.06 so that no draw lands it on either side of the 0.05 floor)
FILTER_RATES = (0.5, 0.2, 0.1, 0.06, 0.02, 0.01, 0.005, 0.001)


def label_rows(member) -> list:
    """(N, L) bool membership -> one label list per row."""
    return [row.nonzero()[0].tolist() for row in member]


def filter_searches() -> list:
    """The filter phase's searches: (name, predicate, its mask from the
    (N, L) membership matrix, search kwargs, on the IVF index)."""
    from repro_torch.filter import All, Any, Not

    def lbl(i):
        return lambda m: m[:, i]

    return [
        ("unfiltered", None, None, {}, False),
        *[(f"label {i}", i, lbl(i), {}, False) for i in range(7)],
        ("All(0, 1)", All(0, 1), lambda m: m[:, 0] & m[:, 1], {}, False),
        ("Any(4, 5)", Any(4, 5), lambda m: m[:, 4] | m[:, 5], {}, False),
        ("Not(0)", Not(0), lambda m: ~m[:, 0], {}, False),
        ("label 5 rerank=False", 5, lbl(5), {"rerank": False}, False),
        ('label 0 nav="bq1"', 0, lbl(0), {"nav": "bq1"}, False),
        ("label 1 adaptive=True", 1, lbl(1), {"adaptive": True}, False),
        ('label 1 nav="ivf"', 1, lbl(1), {"nav": "ivf"}, True),
    ]


def filtered_truth(base, queries, mask, k: int = 10):
    """Exact filtered cosine top-k: (ids, scores) over the rows of
    ``mask``."""
    import numpy as np

    from repro_torch.core.baselines import flat_search

    match = np.nonzero(mask)[0]
    ids, scores = flat_search(base[match], queries, k, device="cuda")
    return match[ids], scores


def brute_bq2_scores(torch, index, queries, mask, k: int = 10):
    """The top-k scores of an exact bq2 scan over the rows of ``mask``, by
    the plain distance (``bq.pairwise_distance``): the brute route without
    rerank must return these scores."""
    import numpy as np

    from repro_torch.core import bq
    from repro_torch.core.metric import normalize

    match = torch.from_numpy(np.nonzero(mask)[0]).cuda()
    qs = bq.encode(normalize(torch.as_tensor(queries, device="cuda")))
    rows = bq.Signature(words=index.sigs.words[match], dim=index.sigs.dim)
    scores = -bq.pairwise_distance(qs, rows).float() - 4 * index.sigs.dim
    return torch.topk(scores, k, dim=1).values.cpu().numpy()


def phase_filter(torch, main: dict | None, ivf: dict | None) -> dict:
    """Filtered search and query plans at deployment size, on phase 4's
    graph and phase 5's IVF index (each built here when its phase did not
    run); returns the phase's launch counts."""
    import numpy as np

    from repro_torch.core.baselines import flat_search, recall_at_k
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import build as kbuild
    from repro_torch.plan import resolve_plan

    n, n_queries = 100_000, 1000
    if main is not None:
        base, queries, truth = main["data"]
        graph, graph_recall = main["index"], main["recall"]
    else:
        base, queries = make_dataset("cohere-surrogate", n, queries=n_queries)
        truth, _ = flat_search(base, queries, 10, device="cuda")
        log("  (phase 4 did not run: building its bq2 graph first)")
        graph = QuIVerIndex.build(base, BuildParams(), device="cuda")
        graph_recall = recall_at_k(graph.search(queries, k=10, ef=64)[0],
                                   truth)
    if ivf is not None:
        ivf_index, ivf_recall = ivf["index"], ivf["ivf_recall"]
    else:
        log("  (phase 5 did not run: building its IVF index first)")
        ivf_index = QuIVerIndex.build(base, BuildParams(ivf_candidates=True),
                                      device="cuda")
        ivf_recall = recall_at_k(
            ivf_index.search(queries, k=10, ef=128, nav="ivf")[0], truth)
    torch.cuda.synchronize()
    t_phase = time.perf_counter()

    kbuild.reset_launches()
    rng = np.random.default_rng(0)
    member = np.stack([rng.random(n) < p for p in FILTER_RATES], axis=1)
    rows = label_rows(member)
    graph.attach_labels(rows, n_labels=len(FILTER_RATES))
    ivf_index.attach_labels(rows, n_labels=len(FILTER_RATES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = graph.build_label_entries(min_count=32)
    torch.cuda.synchronize()
    entries_s = time.perf_counter() - t0
    log(f"  {len(FILTER_RATES)} labels at rates {FILTER_RATES}: members "
        f"{graph.labels.counts.tolist()}, "
        f"{graph.memory_breakdown()['hot_label_bytes']} label bytes; "
        f"build_label_entries(min_count=32): {built} entries "
        f"{graph.labels.entries.tolist()} in {entries_s:.3f} s")

    searches = filter_searches()
    runs, failures = [], []
    for name, pred, mask_of, kw, on_ivf in searches:
        index = ivf_index if on_ivf else graph
        plan, ctx = resolve_plan(index, k=10, ef=64, filter=pred, **kw)
        mask = mask_of(member) if mask_of is not None else None
        if mask is not None:
            want_ids, want_scores = filtered_truth(base, queries, mask)
        else:
            want_ids, want_scores = truth, None
        hub = None
        if plan.adaptive:
            index.plans.obs = hub = smoke_hub()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, scores = index.search(queries, k=10, ef=64, filter=pred, **kw)
        secs = time.perf_counter() - t0
        index.plans.obs = None
        recall = recall_at_k(ids, want_ids)
        note = ""
        if hub is not None:
            note = f", {int(escalated(hub))} escalated at ef {plan.ef} x " \
                f"{plan.escalate_mult}"
        log(f"  {name}: route {plan.route}, ef {plan.ef}"
            f"{f', probes {plan.probes}' if plan.route == 'ivf' else ''}, "
            f"selectivity {ctx.selectivity}, start {ctx.start}: "
            f"{secs:.3f} s, {n_queries / secs:.1f} QPS, recall@10 "
            f"{recall:.4f}{note}")
        runs.append((name, pred, kw, index, plan, ctx))
        if ids.shape != (n_queries, 10) or ids.max() >= n:
            raise AssertionError(f"{name}: search output malformed")
        if mask is None:
            if main is not None and not np.array_equal(ids, main["ids"]):
                failures.append(f"{name}: ids differ from phase 4's")
            continue
        if not mask[ids[ids >= 0]].all():
            failures.append(f"{name}: an id outside its predicate")
        if plan.route == "brute" and plan.rerank:
            ids_match(ids, want_ids, scores, want_scores)
        elif plan.route == "brute":
            want = brute_bq2_scores(torch, index, queries, mask)
            if not np.array_equal(scores, want):
                failures.append(f"{name}: scores differ from an exact "
                                "bq2 scan")
        elif plan.route == "ivf" and recall < ivf_recall - 0.05:
            failures.append(f"{name}: recall@10 {recall:.4f} below the "
                            f"ivf route's {ivf_recall:.4f} - 0.05")
        elif plan.route == "graph" and recall < graph_recall - 0.05:
            failures.append(f"{name}: recall@10 {recall:.4f} below the "
                            f"graph's {graph_recall:.4f} - 0.05")

    # steady state: warm every program at the bucket ladder, then run the
    # whole set again, each search at one of the warmed buckets in turn,
    # with no first run at a new key and no miss
    caches = {id(graph.plans): graph.plans, id(ivf_index.plans):
              ivf_index.plans}
    buckets = (8, 32, 128, 256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, pred, kw, index, plan, ctx in runs:
        index.plans.warmup(plan, ctx, buckets=buckets)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    misses = {key: c.misses for key, c in caches.items()}
    t0 = time.perf_counter()
    for i, (name, pred, kw, index, plan, ctx) in enumerate(runs):
        index.search(queries[:buckets[i % 4]], k=10, ef=64, filter=pred,
                     **kw)
    torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    for key, cache in caches.items():
        report = cache.report()
        log(f"  plans report: {json.dumps(report)}")
        if report["retraces"] != 0 or cache.misses != misses[key]:
            failures.append(f"steady state: {report['retraces']} retraces, "
                            f"{cache.misses - misses[key]} new misses")
    launches = dict(kbuild.LAUNCHES)
    phase_s = time.perf_counter() - t_phase
    log(f"  warmup at buckets {buckets} {warm_s:.1f} s, the set again "
        f"(8, 32, 128 or 256 queries a search) {rerun_s:.1f} s; phase "
        f"{phase_s:.1f} s")
    log(f"  launches on the filter path: {launches}")
    for name in ("binarize", "bq_dist_rows", "list_scan",
                 "hamming_dist_rows"):
        if launches.get(name, 0) == 0:
            failures.append(f"{name} never launched on the filter path")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


# FreshDiskANN's steady-state churn at the reference benchmark's rate
# (benchmarks/streaming.py: 5% of the corpus a cycle), two cycles
STREAM_CHURN, STREAM_CYCLES = 0.05, 2


def live_truth(base, queries, slot_row, live, k: int = 10):
    """Exact cosine top-k over the live slots (``slot_row`` maps a slot to
    its row of ``base``), as slot ids."""
    import numpy as np

    from repro_torch.core.baselines import flat_search

    slots = np.nonzero(live)[0]
    ids, _ = flat_search(base[slot_row[slots]], queries, k, device="cuda")
    return slots[ids]


def phase_stream(torch, main: dict | None) -> dict:
    """The streaming index at deployment size on phase 4's graph (built
    here when phase 4 did not run); returns the phase's launch counts."""
    import numpy as np

    from repro_torch.core.baselines import flat_search, recall_at_k
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import build as kbuild
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.probe import ProbeAccumulator
    from repro_torch.stream import MutableQuIVerIndex

    if main is not None:
        base, queries, truth = main["data"]
        graph, recall4 = main["index"], main["recall"]
        ids4, scores4 = main["ids"], main["scores"]
    else:
        base, queries = make_dataset("cohere-surrogate", 100_000,
                                     queries=1000)
        truth, _ = flat_search(base, queries, 10, device="cuda")
        log("  (phase 4 did not run: building its bq2 graph first)")
        graph = QuIVerIndex.build(base, BuildParams(), device="cuda")
        ids4, scores4 = graph.search(queries, k=10, ef=64)
        recall4 = recall_at_k(ids4, truth)
    n, n_queries = len(base), len(queries)
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    failures = []

    def timed(label, fn, count=None):
        """``fn()`` and its seconds (synchronized), logged with ``count``
        a second where a count is given."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rate = f", {count / secs:.1f} a second" if count else ""
        log(f"  {label}: {secs:.3f} s{rate}")
        return out, secs

    kbuild.reset_launches()
    mut = MutableQuIVerIndex.from_index(graph)
    monitor = mut.attach_drift_monitor(tenant="smoke",
                                       registry=MetricsRegistry())
    graph_monitor, _ = timed(
        "attach_graph_monitor (the X-ray of the adopted graph)",
        lambda: mut.attach_graph_monitor(tenant="smoke",
                                         registry=MetricsRegistry()))
    log(f"    graph band {graph_monitor.band}, score "
        f"{graph_monitor.last_score:.4f}")
    log(f"  adopted phase 4's graph: capacity {mut.capacity}, "
        f"{mut.n_live} live, medoid {mut.medoid}, drift band "
        f"{monitor.band}; memory_breakdown "
        f"{json.dumps(mut.memory_breakdown())}")

    # zero churn: the mutable search and the frozen snapshot equal phase 4
    (ids, scores), _ = timed(
        f"search {n_queries} queries, mutable (direct beam), zero churn",
        lambda: mut.search(queries, k=10, ef=64), n_queries)
    if not (np.array_equal(ids, ids4) and np.array_equal(scores, scores4)):
        failures.append("zero churn: mutable ids or scores differ from "
                        "phase 4's")
    frozen = mut.freeze()
    (f_ids, f_scores), _ = timed(
        f"search {n_queries} queries, frozen, zero churn",
        lambda: frozen.search(queries, k=10, ef=64), n_queries)
    if not (np.array_equal(f_ids, ids4) and np.array_equal(f_scores,
                                                           scores4)):
        failures.append("zero churn: frozen ids or scores differ")
    del frozen
    # the cost of the plan lowering: the same graph, A B A B
    pair = {"mutable (direct beam)": [], "immutable (plans)": []}
    for _ in range(2):
        for label, index in (("mutable (direct beam)", mut),
                             ("immutable (plans)", graph)):
            _, secs = timed(f"search {n_queries} queries, {label}",
                            lambda: index.search(queries, k=10, ef=64),
                            n_queries)
            pair[label].append(secs)
    log(f"  A B A B on one graph: " + "; ".join(
        f"{label} {', '.join(f'{s:.3f}' for s in secs)} s"
        for label, secs in pair.items()))

    # the row of ``base`` each slot holds
    slot_row = np.full(mut.capacity, -1, dtype=np.int64)
    slot_row[:n] = np.arange(n)

    def check_acc(step):
        if mut.probe_acc != ProbeAccumulator.from_words(
                mut.words[torch.from_numpy(mut.live).cuda()], mut.dim):
            failures.append(f"{step}: the accumulator differs from the "
                            "live words'")

    def search_gated(step, dead, gt, ef=64):
        (got, _), secs = timed(f"{step}: search {n_queries} queries at ef "
                               f"{ef}", lambda: mut.search(queries, k=10,
                                                           ef=ef),
                               n_queries)
        if dead is not None and np.isin(got, dead).any():
            failures.append(f"{step}: a deleted id was returned")
        r = recall_at_k(got, gt)
        log(f"    recall@10 against the live truth {r:.4f}")
        return got, r

    def self_hit(step, index, vectors, want, ef):
        """The share of ``vectors`` whose k = 1 search returns ``want``."""
        (hit, _), _ = timed(f"{step}: self search of {len(vectors)} at k=1, "
                            f"ef {ef}", lambda: index.search(vectors, k=1,
                                                             ef=ef),
                            len(vectors))
        share = float((hit[:, 0] == want).mean())
        log(f"    found at k=1: {share:.4f}")
        return share

    # the quality bars are held where the reference sets them: at a search
    # as wide as the insert's own beam (its tests search at ef 48 over
    # ef_construction 32, its churn benchmark at ef = ef_construction 64).
    # Every step is also searched at ef 64 and printed.
    ef_bar = graph.params.ef_construction
    r_rebuild = recall_at_k(graph.search(queries, k=10, ef=ef_bar)[0], truth)
    log(f"  phase 4's graph (the rebuild of the churned corpus) at ef "
        f"{ef_bar}: recall@10 {r_rebuild:.4f}")

    n_churn = int(STREAM_CHURN * n)
    for cycle in range(STREAM_CYCLES):
        rng = np.random.default_rng(cycle)
        dead = rng.choice(np.nonzero(mut.live)[0], n_churn, replace=False)
        rows = slot_row[dead]
        log(f"  cycle {cycle} (delete seed {cycle}): {n_churn} deletes")
        for ef in (64, ef_bar):        # the same vectors before the churn
            self_hit(f"cycle {cycle} before delete, the first 1000",
                     mut, base[rows[:1000]], dead[:1000], ef)
        gone, _ = timed(f"delete {n_churn}", lambda: mut.delete(dead),
                        n_churn)
        if gone != n_churn:
            failures.append(f"cycle {cycle}: {gone} of {n_churn} deleted")
        check_acc(f"cycle {cycle} delete")
        gt = live_truth(base, queries, slot_row, mut.live)
        _, r_before = search_gated(f"cycle {cycle} after delete", dead, gt)
        report, cons_s = timed("consolidate (with the graph X-ray)",
                               mut.consolidate)
        log(f"    consolidate: {report['repaired_rows']} rows repaired, "
            f"{report['reclaimed']} slots reclaimed in {cons_s:.3f} s; "
            f"graph band {report['health_band']}, score "
            f"{report['health_score']:.4f}, delta "
            f"{report.get('health_delta', 0.0):+.4f}")
        if mut.graph_health.n_live != mut.n_live:
            failures.append(f"cycle {cycle}: the X-ray's n_live "
                            f"{mut.graph_health.n_live} is not the live "
                            f"count {mut.n_live}")
        if report["reclaimed"] != n_churn:
            failures.append(f"cycle {cycle}: {report['reclaimed']} slots "
                            "reclaimed")
        check_acc(f"cycle {cycle} consolidate")
        _, r_after = search_gated(f"cycle {cycle} after consolidate", dead,
                                  gt)
        if r_after < r_before - 0.02:
            failures.append(f"cycle {cycle}: recall after consolidate "
                            f"{r_after:.4f} < {r_before:.4f} - 0.02")
        slots, _ = timed(f"re-insert {n_churn}",
                         lambda: mut.insert(base[rows]), n_churn)
        if set(slots.tolist()) != set(dead.tolist()):
            failures.append(f"cycle {cycle}: the re-insert did not reuse "
                            "exactly the reclaimed slots")
        slot_row[slots] = rows
        check_acc(f"cycle {cycle} re-insert")
        adj = mut.adjacency
        indeg = torch.bincount(adj[adj >= 0].long(),
                               minlength=mut.capacity).cpu().numpy()
        others = np.setdiff1d(np.nonzero(mut.live)[0], slots)
        log(f"    in-degree: re-inserted {indeg[slots].mean():.2f}, the "
            f"other live {indeg[others].mean():.2f}; out-degree "
            f"re-inserted {mut.deg[torch.from_numpy(slots).cuda()].float().mean():.2f}")
        self_hit(f"cycle {cycle} re-inserted, the first 1000", mut,
                 base[rows[:1000]], slots[:1000], 64)
        hit = self_hit(f"cycle {cycle} re-inserted", mut, base[rows], slots,
                       ef_bar)
        if hit <= 0.9:
            failures.append(f"cycle {cycle}: self-hit {hit:.4f} at ef "
                            f"{ef_bar}")
        # the live corpus is phase 4's again, and phase 4's graph is its
        # rebuild
        if not np.array_equal(np.sort(slot_row[mut.live]), np.arange(n)):
            failures.append(f"cycle {cycle}: the live rows are not phase "
                            "4's corpus")
        gt = live_truth(base, queries, slot_row, mut.live)
        _, r_final = search_gated(f"cycle {cycle} after re-insert", None, gt)
        log(f"    against phase 4's {recall4:.4f} at ef 64: "
            f"{r_final - recall4:+.4f}")
        _, r_bar = search_gated(f"cycle {cycle} after re-insert", None, gt,
                                ef=ef_bar)
        log(f"    against the rebuild's {r_rebuild:.4f} at ef {ef_bar}: "
            f"{r_bar - r_rebuild:+.4f}")
        if r_bar < r_rebuild - 0.03:
            failures.append(f"cycle {cycle}: recall after re-insert "
                            f"{r_bar:.4f} at ef {ef_bar} < the rebuild's "
                            f"{r_rebuild:.4f} - 0.03")

    # freeze the churned index: the frozen search against the mutable one
    (m_ids, _), _ = timed(f"search {n_queries} queries, mutable after "
                          "churn", lambda: mut.search(queries, k=10, ef=64),
                          n_queries)
    frozen, _ = timed("freeze", mut.freeze)
    (f_ids, _), _ = timed(f"search {n_queries} queries, frozen after churn",
                          lambda: frozen.search(queries, k=10, ef=64),
                          n_queries)
    live_idx = np.nonzero(mut.live)[0]
    r_mut = recall_at_k(m_ids, gt)
    r_frozen = recall_at_k(live_idx[f_ids], gt)
    log(f"  frozen recall@10 {r_frozen:.4f}, mutable {r_mut:.4f}; ids "
        f"through live_idx identical: "
        f"{bool(np.array_equal(live_idx[f_ids], m_ids))}")
    if abs(r_frozen - r_mut) > 0.005:
        failures.append(f"frozen recall {r_frozen:.4f} is not within 0.005 "
                        f"of the mutable {r_mut:.4f}")
    if monitor.alarms:
        failures.append(f"drift alarms on green churn: "
                        f"{[a.message() for a in monitor.alarms]}")
    torch.cuda.synchronize()
    launches = dict(kbuild.LAUNCHES)
    log(f"  stats {mut.stats}; drift band {monitor.band}, "
        f"{len(monitor.alarms)} alarms; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    log(f"  launches on the stream path: {launches}")
    log(f"  bq_pairwise launches by pool size: {pool_sizes(launches)}")
    for name in ("binarize", "bq_dist_rows", "bq_pairwise"):
        if launches.get(name, 0) == 0:
            failures.append(f"{name} never launched on the stream path")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


# the engine phase's traffic: phase 4's first 1 000 queries as three
# tenants' requests, a window pumped every ENGINE_EVERY requests
ENGINE_RAG, ENGINE_BATCH, ENGINE_BATCH_SIZE, ENGINE_CAPPED = 512, 24, 16, 104
ENGINE_EVERY = 64
# every bucket of the ladder the traffic reaches (query_batch 256)
ENGINE_BUCKETS = (8, 32, 128, 256)
# the forced breach's recall floor.  Recall@10 on cohere-surrogate is all
# or nothing a query (the beam finds a query's ten neighbours, which sit
# in one tight subcluster, or none of them: 0.0 or 1.0, ~85% 1.0), so a
# tenant's window median is 1.0, and the ledger's rule (median < floor)
# breaches no floor <= 1.0; a floor above every recall forces the breach
ENGINE_FORCED_SLO = 1.001


def stage_totals(registry) -> dict:
    """Per-stage (count, seconds) of the engine's lifecycle spans, from
    the tracer's ``quiver_stage_seconds`` histogram."""
    hist = registry.histogram("quiver_stage_seconds",
                              labels=("stage",))
    return {key[0]: (slot.count, slot.sum)
            for key, slot in hist.series().items()}


def host_graph_check(index, report) -> None:
    """The X-ray against plain host computations on the adjacency: mean
    out- and in-degree, reciprocity (an edge whose reverse edge exists),
    and a host BFS from the medoid (``scipy.sparse.csgraph``) for the
    unreachable rows and the hop radius."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order

    adj = index.adjacency.cpu().numpy()
    n = adj.shape[0]
    rows, cols = np.nonzero(adj >= 0)
    dst = adj[rows, cols].astype(np.int64)
    out_mean = float((adj >= 0).sum(1).mean())
    in_mean = float(np.bincount(dst, minlength=n).mean())
    keys = rows.astype(np.int64) * n + dst
    recip = float(np.isin(dst * n + rows, keys).sum() / len(keys))
    graph = csr_matrix((np.ones(len(dst), np.int8), (rows, dst)),
                       shape=(n, n))
    order, pred = breadth_first_order(graph, index.medoid, directed=True,
                                      return_predecessors=True)
    hop = np.full(n, -1, np.int64)
    hop[order[0]] = 0
    for node in order[1:]:
        hop[node] = hop[pred[node]] + 1
    got = (report.out_degree_mean, report.in_degree_mean,
           report.reciprocity, report.n_unreachable, report.hop_max)
    want = (out_mean, in_mean, recip, n - len(order), float(hop.max()))
    for name, a, b in zip(("out_degree_mean", "in_degree_mean",
                           "reciprocity", "n_unreachable", "hop_max"),
                          got, want):
        if abs(a - b) > 1e-9 * max(1.0, abs(b)):
            raise AssertionError(f"X-ray {name} {a} vs the host's {b}")
    log(f"  X-ray against the host: out-degree {out_mean:.4f}, in-degree "
        f"{in_mean:.4f}, reciprocity {recip:.6f}, {n - len(order)} "
        f"unreachable, hop radius {hop.max()} (scipy BFS): equal")


def phase_engine(torch, main: dict | None, ivf: dict | None) -> dict:
    """The serving engine at deployment size on phase 4's graph, then
    swapped onto phase 5's IVF index (each built here when its phase did
    not run); returns the phase's launch counts."""
    import numpy as np

    from repro_torch.core.baselines import flat_search
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import build as kbuild
    from repro_torch.obs import MetricsRegistry, ObsHub, RemediationPolicy
    from repro_torch.plan import trace
    from repro_torch.serve.engine import QueryEngine

    n, n_queries = 100_000, 1000
    if main is not None:
        base, queries, truth = main["data"]
        graph, ids4, scores4 = main["index"], main["ids"], main["scores"]
    else:
        base, queries = make_dataset("cohere-surrogate", n, queries=n_queries)
        truth, _ = flat_search(base, queries, 10, device="cuda")
        log("  (phase 4 did not run: building its bq2 graph first)")
        graph = QuIVerIndex.build(base, BuildParams(), device="cuda")
        ids4, scores4 = graph.search(queries, k=10, ef=64)
    if ivf is not None:
        ivf_index = ivf["index"]
    else:
        log("  (phase 5 did not run: building its IVF index first)")
        ivf_index = QuIVerIndex.build(base, BuildParams(ivf_candidates=True),
                                      device="cuda")
    queries = np.asarray(queries, np.float32)
    row_of = {q.tobytes(): i for i, q in enumerate(queries)}
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    kbuild.reset_launches()
    failures = []

    reprobe_s = []

    class TimedPolicy(RemediationPolicy):
        """The remediation policy, its re-probes timed."""

        def _reprobe(self):
            t0 = time.perf_counter()
            report = super()._reprobe()
            torch.cuda.synchronize()
            reprobe_s.append(time.perf_counter() - t0)
            return report

    registry = MetricsRegistry()
    engine = QueryEngine(graph, shadow={"rate": 8}, obs=ObsHub(registry))
    policy = TimedPolicy(engine, auto=True)
    engine.set_quota("rag", qps=1e9, recall_slo=0.75)
    engine.set_quota("capped", qps=50.0, burst=8)
    offers, drained = tap_shadow(engine.shadow)
    configs = ({}, {"ef": 32}, {"ef": 16})       # the deadline ladder
    t0 = time.perf_counter()
    warmed = engine.warmup(buckets=ENGINE_BUCKETS, configs=configs)
    torch.cuda.synchronize()
    log(f"  warmup: {warmed} (stage, bucket) programs, plans "
        f"{[engine.default_ef] + [c['ef'] for c in configs[1:]]} at "
        f"buckets {ENGINE_BUCKETS}: {time.perf_counter() - t0:.2f} s")

    reqs = engine_requests(ENGINE_RAG, ENGINE_BATCH, ENGINE_BATCH_SIZE,
                           ENGINE_CAPPED)
    passes = []
    for attempt in range(2):
        before = (dict(vars(engine.stats)), stage_totals(registry))
        snap = trace.snapshot(graph.plans.trace_prefix())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tickets = drive_engine(engine, queries, reqs, ENGINE_EVERY)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        retraces = snap.delta()
        passes.append(tickets)
        stats, stages = vars(engine.stats), stage_totals(registry)
        split = {st: stages.get(st, (0, 0.0))[1]
                 - before[1].get(st, (0, 0.0))[1]
                 for st in ("window", "coalesce", "launch", "finalize",
                            "shadow")}
        count = {key: stats[key] - before[0][key]
                 for key in ("requests", "queries", "windows", "batches",
                             "done", "dropped", "degraded", "rejected")}
        tenants = engine.tenants.report()["tenants"]
        log(f"  pass {attempt + 1}: {secs:.3f} s, "
            f"{count['requests'] / secs:.1f} requests/s, "
            f"{count['queries'] / secs:.1f} queries/s; {count}; "
            f"retraces {retraces}")
        log(f"    window split (s): " + ", ".join(
            f"{st} {v:.4f}" for st, v in split.items())
            + " (coalesce = plan resolution and degradation)")
        log(f"    latency by tenant (ms, cumulative): " + "; ".join(
            f"{t} p50 {r['p50_ms']} p99 {r['p99_ms']}"
            for t, r in sorted(tenants.items())))
        if attempt == 1 and retraces:
            failures.append(f"pass 2: {retraces} retraces "
                            f"({snap.delta_by_program()})")

    # gates 1 and 2: ids against direct search, rejections, counters
    undegraded = rejected = 0
    for tickets in passes:
        for t, (tenant, row, count, _) in zip(tickets, reqs):
            tk = engine.ticket(t)
            ids, scores = engine.poll(t)
            if tk.status in ("rejected", "dropped"):
                rejected += tk.status == "rejected"
                if not ((ids == -1).all() and np.isneginf(scores).all()):
                    failures.append(f"ticket {t}: {tk.status} with results")
                if tk.status == "rejected" and tenant != "capped":
                    failures.append(f"ticket {t}: {tenant} rejected")
                continue
            if tk.status != "done":
                failures.append(f"ticket {t}: {tk.status}")
            elif not tk.degraded:
                undegraded += 1
                try:
                    ids_match(ids, ids4[row:row + count], scores,
                              scores4[row:row + count])
                except AssertionError as e:
                    failures.append(f"ticket {t} against direct search: "
                                    f"{e}")
    rep = engine.stats_report()
    if rep["requests"] != rep["done"] + rep["dropped"] + rep["rejected"]:
        failures.append(f"counters do not add up: {rep}")
    if rep["tenant_report"]["quota_violations"]:
        failures.append("a quota violation")
    log(f"  {undegraded} undegraded done requests equal to direct search; "
        f"{rejected} rejections, all capped; stats {json.dumps({k: rep[k] for k in ('requests', 'done', 'dropped', 'degraded', 'rejected', 'windows', 'batches')})}")

    # gate 3: every drained shadow recall is its row's exact recall
    want = shadow_expected(offers, row_of, truth, engine.shadow.rate)
    got = [d["recall"] for d in drained]
    if got != want:
        failures.append(f"shadow recalls: {len(got)} drained, {len(want)} "
                        "expected, or a value differs")
    host_bytes = graph.memory_breakdown()["host_shadow_bytes"]
    if host_bytes <= 0:
        failures.append("host_shadow_bytes is 0")
    shadow_s = stage_totals(registry).get("shadow", (0, 0.0))
    log(f"  shadow lane: {engine.shadow.sampled} sampled, {len(got)} "
        f"recalls drained, each its row's exact recall (mean "
        f"{np.mean(got):.4f}); drains {shadow_s[0]} x, {shadow_s[1]:.3f} s; "
        f"host_shadow_bytes {host_bytes}")

    # gate 4: health, then a forced recall-SLO breach on a green corpus
    verdicts = engine.health_verdicts()
    if verdicts.get("recall_slo") != "green":
        failures.append(f"health_verdicts {verdicts} with rag's SLO only")

    def recall_state(tenant):
        rec = engine.tenants.report()["tenants"][tenant]
        return {key: rec[key] for key in ("recall_p50", "recall_n")}

    log(f"  before arming: batch {recall_state('batch')}, rag "
        f"{recall_state('rag')}")
    engine.set_quota("batch", qps=1e9, recall_slo=ENGINE_FORCED_SLO)
    events = len(policy.events)
    breach = [r for r in reqs if r[0] == "batch" and not r[3]]
    t0 = time.perf_counter()
    drive_engine(engine, queries, breach, ENGINE_EVERY)
    torch.cuda.synchronize()
    breach_s = time.perf_counter() - t0
    fired = [e for e in list(policy.events)[events:]]
    actions = [(e["action"], e.get("ef")) for e in fired]
    log(f"  health_verdicts {verdicts}; batch's SLO {ENGINE_FORCED_SLO} "
        f"armed, "
        f"{len(breach)} batch requests ({breach_s:.3f} s, the re-probe "
        f"{sum(reprobe_s):.3f} s): remediation {actions}, "
        f"default_ef {engine.default_ef}")
    if actions != [("reprobe", None), ("escalate_ef", "64->128")] \
            or engine.default_ef != 128:
        failures.append(f"the breach fired {actions}, default_ef "
                        f"{engine.default_ef}; expected reprobe, "
                        "escalate_ef 64->128")
    policy.resolve()

    # the baseline: 64 rag singletons through index.search, one at a time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for row in range(64):
        graph.search(queries[row], k=10, ef=64)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    log(f"  baseline: 64 singletons through index.search one at a time "
        f"{single_s:.3f} s, {64 / single_s:.1f} queries/s")

    # gate 6: the swap onto phase 5's IVF index, default nav and ivf
    t0 = time.perf_counter()
    engine.swap_index(ivf_index, warmup=True)
    engine.warmup(buckets=ENGINE_BUCKETS, configs=({}, {"nav": "ivf"}))
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    swap = [("rag", row, 1, {}) for row in range(256)] \
        + [("rag", row, 1, {"nav": "ivf"}) for row in range(256)]
    t0 = time.perf_counter()
    with trace.assert_no_retrace(ivf_index.plans.trace_prefix(),
                                 "after the swap") as snap:
        tickets = drive_engine(engine, queries, swap, ENGINE_EVERY)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    for nav, part in ((None, tickets[:256]), ("ivf", tickets[256:])):
        want_ids, want_sc = ivf_index.search(queries[:256], k=10, ef=64,
                                             nav=nav)
        got_ids = np.concatenate([engine.poll(t)[0] for t in part])
        got_sc = np.concatenate([engine.poll(t)[1] for t in part])
        ids_match(got_ids, want_ids, got_sc, want_sc)
    log(f"  swap onto phase 5's index with warmup {swap_s:.3f} s; 2 x 256 "
        f"singletons (default nav, nav=ivf) {served_s:.3f} s, ids equal to "
        f"its direct search, {snap.delta()} retraces")

    # gate 7: the X-ray of phase 4's graph against the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xray = graph.graph_report(sample=256, agreement_k=8)
    torch.cuda.synchronize()
    xray_s = time.perf_counter() - t0
    log(f"  graph_report (S=256, k=8) {xray_s:.3f} s: {xray.summary()}; "
        f"verdict {xray.verdict}, score {xray.health_score:.4f} (printed, "
        "not gated)")
    host_graph_check(graph, xray)

    torch.cuda.synchronize()
    launches = dict(kbuild.LAUNCHES)
    log(f"  launches on the engine path: {launches}")
    log(f"  phase {time.perf_counter() - t_phase:.1f} s")
    for name in ("binarize", "bq_dist_rows", "list_scan"):
        if launches.get(name, 0) == 0:
            failures.append(f"{name} never launched on the engine path")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


def phase_rag(torch, kernels: dict) -> dict:
    """LM serving with RAG at full width and depth; returns its launch
    counts.  ``kernels`` holds phase 2's records, whose device times give
    the flash kernels' share of each step (not measured without them)."""
    import collections

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.baselines import flat_search, recall_at_k
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import matrix_param_count
    from repro_torch.probe import probe_corpus, select_policy
    from repro_torch.serve.engine import QueryEngine, Retriever, \
        ServeEngine, mean_pool_embedder

    n_docs, n_held, doc_len, batch = 8192, 256, 64, 64
    n_prompts, prompt_len, max_new, max_seq, k = 8, 64, 32, 384, 4
    cfg = get_config("minicpm-2b")
    bundle = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = bundle.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = matrix_param_count(model)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} -> "
        f"{cfg.padded_vocab}, bf16: {n_params} parameters (param_count() "
        f"{cfg.param_count()}; plus "
        f"{sum(p.numel() for p in model.parameters()) - n_params} norm "
        f"scales), drawn in {time.perf_counter() - t0:.1f} s")
    if n_params != cfg.param_count():
        raise AssertionError("the module's parameters are not param_count()")

    launches: collections.Counter = collections.Counter()
    variants = dict.fromkeys(("flash_attention_mma",
                              "flash_attention_split_kv",
                              "flash_attention_fma"), 0)
    tally = {name: {"calls": 0, "flash": 0, "s": 0.0, **variants}
             for name in ("embed", "prefill", "decode")}

    def counted(name, fn):
        """``fn`` with the launch counts reset before each call and read
        after it, and its time on the host clock around synchronisation."""
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            kbuild.reset_launches()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec = tally[name]
            rec["s"] += time.perf_counter() - t0
            rec["calls"] += 1
            rec["flash"] += kbuild.LAUNCHES["flash_attention"]
            for key in variants:
                rec[key] += kbuild.LAUNCHES[key]
            launches.update(kbuild.LAUNCHES)
            return result
        return run

    rng = np.random.default_rng(0)
    docs = rng.integers(0, cfg.vocab_size,
                        (n_docs + n_held, doc_len)).astype(np.int32)
    embed_fn = counted("embed", mean_pool_embedder(bundle, model))
    emb = torch.cat([embed_fn(docs[i:i + batch])
                     for i in range(0, len(docs), batch)])
    embed_s = tally["embed"]["s"]
    log(f"  embed {len(docs)} documents x {doc_len} tokens in batches of "
        f"{batch}: {embed_s:.2f} s, {docs.size / embed_s:.0f} tokens/s")
    if emb.shape != (len(docs), cfg.d_model) \
            or not bool(torch.isfinite(emb).all()):
        raise AssertionError("embeddings malformed")
    corpus, held = emb[:n_docs], emb[n_docs:]

    torch.cuda.synchronize()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    index = QuIVerIndex.build(corpus, BuildParams(), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_counts = dict(kbuild.LAUNCHES)
    launches.update(build_counts)
    stats = index.build_stats
    log(f"  QuIVerIndex.build over {n_docs} x {cfg.d_model}: {build_s:.2f} s "
        f"(linking {stats.seconds:.2f} s, {stats.chunks} chunks, mean hops "
        f"{stats.mean_hops:.1f}, {stats.consolidations} consolidations); "
        f"launches {build_counts}")
    for name in ("binarize", "bq_dist_rows", "bq_pairwise"):
        if build_counts.get(name, 0) == 0:
            raise AssertionError(f"{name} never launched in the build")

    kbuild.reset_launches()
    t0 = time.perf_counter()
    report = probe_corpus(corpus, device="cuda")
    probe_s = time.perf_counter() - t0
    launches.update(kbuild.LAUNCHES)
    log(f"  probe {probe_s:.3f} s: {report.summary()} (agreement "
        f"{report.bq_agreement:.4f}) -> {select_policy(report).describe()}")

    truth, _ = flat_search(corpus, held, 10, device="cuda")
    kbuild.reset_launches()
    t0 = time.perf_counter()
    ids, scores = index.search(held, k=10, ef=64)
    search_s = time.perf_counter() - t0
    launches.update(kbuild.LAUNCHES)
    recall = recall_at_k(ids, truth)
    log(f"  recall@10 at ef=64 of {n_held} held-out documents: {recall:.4f} "
        f"({n_held / search_s:.1f} QPS; printed, not gated)")
    if ids.shape != (n_held, 10) or not np.isfinite(scores).all() \
            or ids.min() < 0 or ids.max() >= n_docs:
        raise AssertionError("held-out search output malformed")

    prompts = rng.integers(0, cfg.vocab_size,
                           (n_prompts, prompt_len)).astype(np.int32)
    retriever = Retriever(index=index, doc_tokens=docs[:n_docs],
                          embed_fn=embed_fn, k=k, ef=64)
    served = bundle._replace(prefill=counted("prefill", bundle.prefill),
                             decode=counted("decode", bundle.decode))
    engine = ServeEngine(served, model, max_seq=max_seq, device="cuda")
    runs = []
    for attempt in range(2):
        before = {name: dict(rec) for name, rec in tally.items()}
        t0 = time.perf_counter()
        tokens = engine.generate(prompts, max_new=max_new,
                                 retriever=retriever)
        wall = time.perf_counter() - t0
        runs.append(tokens)
        pre = tally["prefill"]["s"] - before["prefill"]["s"]
        dec = tally["decode"]["s"] - before["decode"]["s"]
        log(f"  generate {attempt + 1}: {n_prompts} prompts x {prompt_len} "
            f"tokens + {k} x {doc_len} retrieved = prefill T = "
            f"{k * doc_len + prompt_len}: prefill {pre * 1e3:.1f} ms, decode "
            f"{dec / max_new * 1e3:.2f} ms a token, "
            f"{tokens.size / wall:.1f} new tokens/s ({wall:.2f} s in all)")
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("two generate runs gave different tokens")
    if runs[0].shape != (n_prompts, max_new) or runs[0].min() < 0 \
            or runs[0].max() >= cfg.vocab_size:
        raise AssertionError("generated tokens malformed")

    # the retrieval the prompts were served with
    hits, _ = index.search(embed_fn(prompts), k=k, ef=64)
    if hits.min() < 0 or hits.max() >= n_docs:
        raise AssertionError("a retrieved id is out of range")
    ctx = retriever.augment(prompts)[:, :k * doc_len] \
        .reshape(n_prompts, k, doc_len)
    if not np.array_equal(ctx, docs[hits]):
        raise AssertionError("a context row is not its document's tokens")
    log(f"  retrieval: {hits.size} ids in range, every context row its "
        f"document's tokens; first prompt's ids {hits[0].tolist()}")
    # the same retrieval through the serving engine's admission queue
    routed = Retriever(index=index, doc_tokens=docs[:n_docs],
                       embed_fn=embed_fn, k=k, ef=64,
                       engine=QueryEngine(index, obs=False))
    if not np.array_equal(routed.augment(prompts),
                          retriever.augment(prompts)):
        raise AssertionError("Retriever(engine=...) retrieved other "
                             "documents than the direct Retriever")
    log(f"  Retriever(engine=QueryEngine(index, obs=False)): the "
        f"{n_prompts} prompts' retrieved documents equal the direct "
        "Retriever's")

    # filtered retrieval: two labels on the indexed documents, and the
    # prompts served documents of label 1 only
    member = np.random.default_rng(1).random((n_docs, 2)) < (0.5, 0.1)
    index.attach_labels(label_rows(member), n_labels=2)
    emb = embed_fn(prompts)
    kbuild.reset_launches()
    hits, _ = index.search(emb, k=k, ef=64, filter=1)
    launches.update(kbuild.LAUNCHES)
    ctx = retriever.augment(prompts, filter=1)[:, :k * doc_len] \
        .reshape(n_prompts, k, doc_len)
    if hits.min() < 0 or not member[hits, 1].all():
        raise AssertionError("a filtered retrieval returned a document "
                             "without the label")
    if not np.array_equal(ctx, docs[hits]):
        raise AssertionError("a filtered context row is not its "
                             "document's tokens")
    log(f"  filtered retrieval (label 1: {int(member[:, 1].sum())} of "
        f"{n_docs} documents): every one of {hits.size} retrieved ids "
        f"carries the label; first prompt's ids {hits[0].tolist()}")

    # each step's flash kernel: its launches x its phase-2 device time at
    # the step's shape (decode at 352 keys, the longest step)
    taken = {"embed": ("flash_attention_mma", "flash_attention_mma"),
             "prefill": ("flash_attention_mma",
                         "flash_attention_mma_prefill"),
             "decode": ("flash_attention_split_kv",
                        "flash_attention_split_kv")}
    for name, rec in tally.items():
        variant, record = taken[name]
        counts = {key: rec[key] for key in variants}
        log(f"  {name}: {rec['calls']} calls, {rec['flash']} flash_attention "
            f"launches {counts}")
        if rec["calls"] == 0 or rec["flash"] != cfg.n_layers * rec["calls"]:
            raise AssertionError(f"flash_attention did not launch "
                                 f"{cfg.n_layers} times a call in {name}")
        if rec[variant] != rec["flash"]:
            raise AssertionError(f"not every {name} call of flash_attention "
                                 f"took {variant}: {counts}")
        call_ms = rec["s"] / rec["calls"] * 1e3
        if record in kernels:
            flash_ms = cfg.n_layers * kernels[record]["ms"]
            log(f"  {name}: {call_ms:.3f} ms a call, of which {variant} "
                f"{flash_ms:.3f} ms ({cfg.n_layers} launches x "
                f"{kernels[record]['ms']:.4f} ms device time, phase 2): "
                f"{flash_ms / call_ms:.1%}")
        else:
            log(f"  {name}: {call_ms:.3f} ms a call; the flash kernel's "
                "share not measured (phase 2 did not run)")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    del engine, retriever, model
    torch.cuda.empty_cache()
    return {"launches": dict(launches)}


def phase_profile(torch, chunks: int = 8) -> None:
    """Where a build's time goes at the main path's size (N = 100 000,
    D = 768, ``BuildParams()``): ``chunks`` chunks and the consolidation
    that follows them, from the random initial graph.  Host-clock stage
    times (each stage synchronised), then the device's busy share and
    device time by kernel under ``torch.profiler``."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import beam, bq, linking, metric, vamana
    from repro_torch.core.index import as_float32, normalize
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import build as kbuild

    n = 100_000
    base, _ = make_dataset("cohere-surrogate", n, queries=0)
    p = vamana.BuildParams()
    backend = metric.make_backend("bq2", metric.MetricArrays(
        sigs=bq.encode(normalize(as_float32(base, "cuda")))))
    medoid = int(linking.medoid_scan(backend, vamana._centroid_repr(backend),
                                     chunk=4096))
    order = torch.from_numpy(
        np.random.default_rng(p.seed).permutation(n).astype(np.int32)).cuda()
    init = vamana._init_graph(n, p, p.seed, "cuda")

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def window(adj, split: bool):
        """``chunks`` chunks, then one consolidation; returns stage secs."""
        deg = (adj >= 0).sum(dim=1, dtype=torch.int32)
        secs = dict.fromkeys(("beam", "hops", "chunk_forward", "edges",
                              "consolidate"), 0.0)
        for ci in range(chunks):
            ids = order[ci * p.chunk:(ci + 1) * p.chunk]
            if split:
                before = kbuild.LAUNCHES["bq_dist_rows"]
                _, t = sync_time(lambda: beam.beam_search(
                    backend.query_repr(ids), adj, medoid,
                    dist_fn=backend.dist_many, ef=p.ef_construction, n=n))
                secs["beam"] += t
                # one distance launch for the entry point, one a hop
                secs["hops"] += kbuild.LAUNCHES["bq_dist_rows"] - before - 1
            fwd, t = sync_time(lambda: linking.chunk_forward(
                backend, adj, ids, medoid, ef=p.ef_construction,
                pool=p.prune_pool, r=p.r, alpha=p.alpha, n=n)[0])
            secs["chunk_forward"] += t

            def edges():
                a, d = linking.apply_forward(adj, deg, ids, fwd,
                                             r_total=p.r_total)
                return linking.reverse_append(a, d, ids, fwd,
                                              r_total=p.r_total)[:2]
            (adj, deg), t = sync_time(edges)
            secs["edges"] += t
        over = int((deg > p.r).sum())
        (adj, deg, _), t = sync_time(lambda: vamana._consolidate_overflow(
            adj, deg, backend, p, p.chunk))
        secs["consolidate"] = t
        return secs, over

    window(init, split=False)                                 # warm-up
    secs, over = window(init, split=True)
    beam_hops = secs["hops"] / chunks
    total = secs["chunk_forward"] + secs["edges"] + secs["consolidate"]
    log(f"  {chunks} chunks + 1 consolidation: {total:.3f} s; per chunk: "
        f"beam {secs['beam'] / chunks * 1e3:.1f} ms "
        f"({beam_hops:.0f} hops, "
        f"{secs['beam'] / chunks / max(beam_hops, 1) * 1e3:.3f} ms a hop), "
        f"prune + pairwise "
        f"{(secs['chunk_forward'] - secs['beam']) / chunks * 1e3:.1f} ms, "
        f"edges {secs['edges'] / chunks * 1e3:.1f} ms; consolidation "
        f"{secs['consolidate'] * 1e3:.1f} ms over {over} rows")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window(init, split=False)
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(dev_us(e) for e in kernels) / 1e6
    log(f"  device busy {device_s:.3f} s of {total:.3f} s unprofiled wall "
        f"({device_s / total:.1%}); profiled wall {wall:.3f} s")
    log("  device time by kernel:")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms {e.count:7d} launches  "
            f"{e.key[:80]}")
    # the port's own kernels (csrc/*.cu); PyTorch's are in at::, and
    # copies and fills are named Memcpy and Memset
    log("  the port's kernels (share of device time):")
    for e in sorted(kernels, key=dev_us, reverse=True):
        if "at::" not in e.key and not e.key.startswith("Mem"):
            log(f"    {dev_us(e) / 1e3:9.2f} ms {e.count:7d} launches "
                f"({dev_us(e) / 1e6 / device_s:.1%})  {e.key[:70]}")
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    log("  host time by operator (self CPU):")
    for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        log(f"    {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d} calls  "
            f"{e.key}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + OPT_IN))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES) - set(OPT_IN)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"clocks: {clocks()}")

    from repro_torch.kernels import build as kbuild

    kernels = {}
    t_all = time.perf_counter()
    if "build" in phases:
        log("phase 1: build")
        seconds = kbuild.build()
        log(f"  nvcc {json.dumps({k: round(v, 2) for k, v in seconds.items()})}"
            f" s (parallel)")
    if "kernels" in phases:
        log("phase 2: kernels against their plain versions, on the card")
        kernels = phase_kernels(torch)
        phase_times(torch, kernels)
    if "parity" in phases:
        log("phase 3: the N=4000 builds on the CPU and on the card")
        phase_parity(torch)
    paths = []
    main_path = ivf_path = None
    if "main" in phases:
        log("phase 4: main path, cohere-surrogate N=100000, 1000 queries")
        main_path = phase_main(torch)
        paths.append(main_path)
    if "ivf" in phases:
        log("phase 5: IVF path, cohere-surrogate N=100000, 1000 queries")
        ivf_path = phase_ivf(torch)
        paths.append(ivf_path)
    if "ladder" in phases:
        log("phase 6: metric ladder, cohere-surrogate N=100000, 1000 "
            "queries; probe of three corpora")
        paths.append(phase_ladder(torch, main_path))
    if "filter" in phases:
        log("phase filter: filtered search and query plans, "
            "cohere-surrogate N=100000, 1000 queries, 8 labels")
        paths.append(phase_filter(torch, main_path, ivf_path))
    if "stream" in phases:
        log("phase stream: the streaming index, cohere-surrogate "
            f"N=100000, {STREAM_CYCLES} cycles of {STREAM_CHURN:.0%} churn")
        paths.append(phase_stream(torch, main_path))
    if "engine" in phases:
        log("phase engine: the serving engine (QueryEngine) and obs/, "
            "cohere-surrogate N=100000, 1000 queries, three tenants")
        paths.append(phase_engine(torch, main_path, ivf_path))
    if "rag" in phases:
        log("phase 7: LM serving with RAG, minicpm-2b at full width and "
            "depth")
        paths.append(phase_rag(torch, kernels))
    if "profile" in phases:
        log("phase 8: profile of build chunks at N=100000")
        phase_profile(torch)
    log(f"all phases {time.perf_counter() - t_all:.1f} s")

    for rec in kernels.values():
        rec["launches"] = sum(p["launches"].get(rec["name"], 0)
                              for p in paths)
    print(card)
    print(json.dumps({"kernels": [
        {key: rec[key] for key in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        for rec in kernels.values() if not rec.get("log_only")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
