#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,ivf
    python3 chip_smoke.py --phases build,kernels,ladder
    python3 chip_smoke.py --phases build,kernels,filter
    python3 chip_smoke.py --phases build,kernels,stream
    python3 chip_smoke.py --phases build,kernels,engine
    python3 chip_smoke.py --phases build,kernels,fleet
    python3 chip_smoke.py --phases build,kernels,rag
    python3 chip_smoke.py --phases build,kernels,moe
    python3 chip_smoke.py --phases build,kernels,hybrid,vlm
    python3 chip_smoke.py --phases build,kernels,ssm,encdec
    python3 chip_smoke.py --phases build,kernels,train
    python3 chip_smoke.py --phases build,profile      # opt-in breakdown
    python3 chip_smoke.py --phases build,kernels,train,trainprof

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
              ragged embed, the served models' shapes at head_dim 128
              (qwen2-moe: 16 heads, embed 64 x 64, prefill 8 x 320 over a
              384-row cache, decode at q_offset 320 and 351; qwen3-moe:
              32 heads over 4 KV heads, prefill and decode; jamba: 32
              heads over 8, embed, prefill and decode; internvl2: 16 heads
              over 8, prefill 8 x (256 patches + 64 tokens) and decode;
              whisper at head_dim 64, 16 heads, without a causal mask:
              its encoder 8 x 1 500 over 1 500, cross-attention prefill 8
              x 64 and decode 8 x 1 over 1 500, and its causal
              self-attention decode at q_offset 95; each logged with its
              time, bound and SDPA's), a ragged Tq 70 over Tk 130 without
              a causal mask, bf16 K/V read
              through a stacked cache's and a fused buffer's strides, and
              a misaligned K that must raise.
              Then each kernel's, its plain version's and one
              PyTorch call's time (a matmul for the distance kernels,
              ``scaled_dot_product_attention`` for flash) on those
              main-path inputs: device time and stream time (see
              ``time_ms``); logged beside them, not in the kernels line:
              ``bq_dist_rows`` at K = 5 256 (the streaming repair's
              candidate row, 72 + 72 x 72), 34 080 and 50 880 (the IVF
              build chunk and search batch, and the fleet's scatter step
              at the default probes), 151 680 at B = 32 (the scatter step
              at every probe, its library levels gathered when it is
              timed), ``bq_pairwise`` at C = 72,
              ``list_scan`` at Q = 8192, ``hamming_pairwise`` at C = 72 and
              ``hamming_dist_rows`` at K = 34 080 (its library bmm over
              26.8 GB of float32 levels, gathered when it is timed).
              ``flash_attention_backward`` (``FLASH_BWD_CASES``: the
              train phase's shape, B 4, T 256, 36 heads of 64, causal,
              bf16; 56 heads over 8 at hd 128; a ragged Tq at q_offset
              50 over a ragged cache; one query row; hd 16 without a
              causal mask; 4096 keys; the train shape in float32), each
              call through the route its dtype selects (bf16: the
              tensor-core kernels given the forward's log-sum-exp,
              ``flash_attention_bwd_mma``; float32: the CUDA-core
              kernels, ``flash_attention_bwd_fma``), against
              ``flash_attention_backward_plain`` on the same forward
              output (float32 within 1e-4, bf16 within 2^-7, of the
              largest gradient), bf16 also against its mirror
              ``flash_attention_backward_mma_plain`` (``MIRROR_RTOL``,
              ``MIRROR_ATOL``); two calls bit for bit equal (the second,
              in bf16, without the log-sum-exp); dK and dV of keys no
              row sees exactly zero; both routes timed at the train
              shape, the bf16 one split by kernel, with SDPA's backward
              (``torch.autograd.grad`` on a saved graph) as the library
              call; the float32 route is logged, not in the kernels
              line (no path launches it).  Head width 192 and sliding
              windows (``FLASH_WINDOW_CASES``, and the backward's
              nemotron and window cases): every forward kernel and both
              backward routes against their plain versions, ptxas's
              report of every hd-192 instance free of spills
              (``ptxas_spills``), and nemotron's embed, prefill and
              decode (96 heads over 8, hd 192), the windows of 128 and
              1 024 keys and the backward at them timed beside their
              bounds and SDPA's time (a boolean mask where a window
              applies), logged.
3. parity   — run in a child process beside phases 4 to fleet when any
              of them runs (``start_parity_child``: a fresh interpreter
              with its torch threads capped at ``os.cpu_count()`` - 2,
              the parent's allocator held to ``PARENT_MEMORY_SHARE`` of
              the card meanwhile, the kernels phase 1 built, its log and
              files under ``build/smoke/parity/``; the parent prints the
              log once the child ends, before phase 7, and fails if the
              child failed or had not ended ``PARITY_WAIT_S`` after the
              index phases;
              its seconds are the child's own, and "parity overlapped"
              says how much of them the index phases hid), inline
              otherwise.  The same ``PARITY_N`` = 2000 builds and
              searches (4000 before the hybrid and vlm phases: a cut of
              depth, the same on every host, that pays for them) on
              ``device="cpu"`` and
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
              row's exact recall; the fleet (``parity_fleet``: N = 2 003
              of cohere-surrogate over 4 shards, one pad row, 2 labels):
              ``build_sharded``'s stacked fields but the cold vectors
              identical, the fan-out unfiltered and with label 0,
              ``build_ivf_sharded``'s placement and its targeted and
              broadcast scatter, and a ``StreamingShardedIndex`` script
              (3 shards: insert 1 200, delete 150 with a medoid,
              consolidate, insert 100, fan-out, ``enable_ivf_routing``,
              scatter) with every shard's state identical; the searches'
              ids identical where their scores, within 1e-6, separate
              them; and ``minicpm-2b`` at full width and 2 layers,
              drawn on the CPU and copied to the card: 2 prompts of 48
              tokens, prefill and 8 greedy decode steps (the card fed the
              CPU's tokens), every logit within 0.1 and equal argmax
              where the CPU's top-2 gap exceeds 0.2, mean-pooled
              embeddings at cosine >= 0.999; ``qwen2-moe-a2.7b`` at full
              width and 1 layer the same way (``parity_moe``: the share of
              (token, layer) top-k sets equal on the two devices >= 0.98,
              logits within 0.1 on rows whose routes all agree, equal
              greedy tokens there where the CPU's top-2 gap exceeds 0.2;
              the capacity dispatch of the CPU's expert ids, of the
              prefill and of a 2 x 320 scoring forward, identical on the
              card); one ``jamba-v0.1-52b`` mamba layer at full width
              (``parity_mamba``: d 4096, d_inner 8192, bf16, a 2 x 64
              prefill and 8 one-token steps with both states carried:
              every output and the final states within 2^-5 of their
              largest |value|); ``jamba-v0.1-52b.smoke()`` in float32
              (``parity_jamba``: 16 layers, prefill and 8 decode steps,
              routes equal >= 0.98, logits of rows whose routes all agree
              within 1e-3, flash 2 x 9); ``internvl2-2b`` at full width
              and 2 layers behind 256 seeded patches (``parity_vlm``:
              parity_lm's rules from position 304, the loss's token count
              2 x 48 and its value within 1e-2); one period of
              ``xlstm-1.3b`` at full width (``parity_xlstm``: 7 mLSTM and
              1 sLSTM layer, d 2048, a 2 x 64 prefill and 8 decode steps
              with every state carried, no flash launch; float32: logits
              within 1e-3 and equal greedy tokens where the CPU's top-2
              gap exceeds 0.2; bf16: each block on the CPU's input and
              state within 2^-5 of each output's and state's largest
              |value|); ``whisper-medium`` at full width with 2 encoder
              and 2 decoder layers (``parity_whisper``: 2 x 1 500 frames,
              prompts of 16 tokens, prefill and 8 decode steps under
              parity_lm's rules, the loss over 2 x 375 tokens: its count
              equal and its value within 1e-2; flash 12 mma and 32
              split-KV launches); then training
              (``parity_train``): the same model, B 2 x S 64, loss within
              1e-2 and gradients at relative L2 within 5e-2 (the
              backward kernel launched once a layer), one train step
              each (loss and grad norm within 1e-2, updates at cosine >=
              0.9), and the card's state as a checkpoint restored on the
              CPU, identical leaf for leaf; then the multi-chip substrate
              (``parity_dist``): a ``nemotron-4-340b`` attention layer at
              full width (hd 192) within 0.1 of the CPU's; on a world-1
              mesh (NCCL and gloo), a 2-layer full-width ``minicpm-2b``
              step under ``use_mesh`` equal bit for bit to the same step
              without it, and a 1-layer full-width ``qwen2-moe-a2.7b``
              forward through the MoE mesh branch in float32, card
              against CPU (top-4 sets >= 0.98 equal, logits within 1e-3,
              the flat row's dispatch identical), and in bf16 (on each
              device the branch's top-4 sets equal the unmeshed path's,
              card against CPU both flip the same tokens, the flat row's
              dispatch identical); the dry-run cells
              ``minicpm-2b x train_4k x 16x16`` and ``quiver-1m x
              16x16``, printed.
4. main     — the main path at deployment size: cohere-surrogate (768-d),
              N = 100 000, 1 000 queries, ``BuildParams()`` defaults;
              build, search at k = 10, ef = 64, recall@10 against exact
              search (gate 0.80), save, load, search again (identical
              ids).  Launch counts are reset just before this phase and
              read just after; every kernel must have launched, and
              the ``bq_pairwise`` launches are printed by pool size.
5. ivf      — the IVF path over the first ``IVF_N`` = 20 000 rows of
              phase 4's corpus (a cut of depth, the same on every host,
              that pays for the moe phase and the multi-chip checks):
              ``BuildParams(
              ivf_candidates=True)``, partition and linking timed apart;
              search ``nav="bq2"`` at ef = 64 (recall gate 0.80) and
              ``nav="ivf"`` at ef = 128 with default probes and with
              ceil(3L/4) probes (gate: graph recall - 0.02); save, load,
              ``nav="ivf"`` again (identical ids).  Launch counts as in 4;
              all four kernels must have launched.
6. ladder   — the metric ladder at the same size (1 000 queries, k = 10,
              ef = 64): a bq1 build (``BuildParams()``) over the first
              ``LADDER_BQ1_N`` = 25 000 rows (a cut of depth, the same
              on every host) searched with ``nav="bq1"``
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
              phase 5's IVF index (its ``IVF_N`` rows and their labels;
              each built here when its phase did not
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
              same graph.  Then ``STREAM_CYCLES`` = 1 cycle (delete
              seed 0; a cut of depth, the same on every host) of
              FreshDiskANN churn at the reference
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
fleet       — the sharded fleet on phase 4's corpus (made here when phase
              4 did not run), k = 10: ``build_sharded`` over the first
              ``FLEET_N`` = 25 003 rows in 4 shards (6 251 rows a shard,
              one pad row in shard 3; a cut of depth, the same on every
              host), ``BuildParams()``, 4 labels drawn from seed 0 at
              ``FLEET_RATES`` (0.5, 0.1, 0.02, 0.005), per-label entries
              (``min_count=32``); each shard's build seconds and hot
              bytes printed.  Gates: 25 003 live rows; rows 25 000-25 002
              found as themselves at k = 1; no id >= 25 003 and none
              repeated in a row; recall@10 at ef = 64 against exact cosine
              over the 25 003 >= 0.80; label 1 and ``Any(2, 3)``: every id
              matches its predicate, recall against the filtered truth >=
              the unfiltered fleet's - 0.05.  Then ``build_ivf_sharded``
              over all 100 000 rows in 4 shards: sizes sum to 100 000,
              every list on one shard; at the default probes and ef = 64
              the targeted ids equal ``broadcast=True``'s (scores within
              1e-6), no query contacts more than min(p, 4) shards,
              ``quiver_ivf_list_routes_total`` sums to Q p; at every probe
              and ef = 256 recall@10 >= 0.9.  Then the 4 graph shards
              adopted as ``MutableQuIVerIndex``es (2x headroom, the pad row
              tombstoned) in a ``StreamingShardedIndex`` with drift
              monitors: zero churn gives step 1's ids slot for slot; delete
              5% (1 250, seed 0), search, consolidate (by shard), search,
              re-insert the same vectors.  Gates: no deleted id returned;
              1 250 + 1 slots reclaimed; new gids unique; recall after
              consolidate >= before - 0.02; the re-inserted rows found at
              k = 1 at ef = ``ef_construction`` in > 0.9 of cases; the
              scatter after ``enable_ivf_routing`` at every probe >= the
              fan-out's recall - 0.01; after one more delete no deleted id
              through the scatter; no drift alarm.  Launch counts as in 4:
              binarize, ``bq_dist_rows``, ``bq_pairwise`` and
              ``list_scan`` must have launched.
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
moe         — MoE serving with RAG, run with nothing of the earlier
              phases on the card: ``qwen2-moe-a2.7b`` at full width and
              depth (24 layers, d 2048, 16 heads of 128, 60 routed experts
              of 1 408 top-4 plus 4 shared, vocab 151 936 -> 152 064,
              bf16 weights from seed 0, the router in float32); the RAG
              path of phase 7 (``serve_lm``) over 1 024 + 128 documents:
              recall@10 at ef = 64 of the 128 held-out ones printed, not
              gated; 8 prompts served twice with identical tokens, ids in
              range, ``flash_attention`` 24 times a call, on the
              tensor-core kernel for embed and prefill and the split-KV
              kernel for decode, the bq kernels in the build.  Printed:
              parameters, peak ``max_memory_allocated``, prefill ms,
              decode ms a token, new tokens/s, embedding tokens/s, the
              dropped fraction of a scoring forward over the 8 augmented
              prompts (8 x 320, cap 32).  Then ``launch.serve.main``
              with ``--arch qwen2-moe-a2.7b --smoke --rag`` on the card.
hybrid      — hybrid serving with RAG: ``jamba-v0.1-52b`` at full width and
              ``HYBRID_LAYERS`` = 16 layers (two whole periods of its
              pattern: 2 attention and 14 mamba layers, MoE 16 experts
              top-2 on the odd ones; 2.605e10 matrix parameters, 52.1 GB
              of bf16; 24 layers would take ~77 GB), weights from seed 0;
              ``serve_lm`` over 1 024 + 128 documents: identical tokens in
              two runs, ids in range, ``flash_attention`` twice a call
              (the attention layers), on the tensor-core kernel for embed
              and prefill and the split-KV kernel for decode, the bq
              kernels in the build.  Printed: peak memory, prefill ms,
              decode ms a token, embedding tokens/s.  Then
              ``launch.serve`` with ``--arch jamba-v0.1-52b --smoke
              --rag`` on the card.
vlm         — vlm serving: ``internvl2-2b`` at full width and depth (24
              layers, d 2048, 16 heads over 8, vocab 92 553, 1.89e9 bf16
              parameters from seed 0): 8 prompts of 64 tokens behind 256
              seeded patch embeddings each, 32 greedy tokens from
              position 320, twice, identical; ``flash_attention`` 24
              times a call (mma for prefill, split-KV for decode); a loss
              over (patches, tokens, labels) counting 8 x 64 tokens.
              Then ``launch.serve --arch internvl2-2b --smoke`` on the
              card.
ssm         — ssm serving with RAG: ``xlstm-1.3b`` at full width and depth
              (48 layers: 42 mLSTM, 6 sLSTM; d 2048, 4 heads, d_inner
              4 096, vocab 50 304 -> 50 688, 2.021e9 bf16 parameters from
              seed 0); ``serve_lm`` over 1 024 + 128 documents: identical
              tokens in two runs, ids in range, every layer's float32
              state carried through decode, ``binarize`` and
              ``bq_dist_rows`` launched and no ``flash_attention`` launch
              (no attention layer).  Printed: peak memory, prefill ms,
              decode ms a token, new tokens/s, embedding tokens/s.  Then
              ``launch.serve --arch xlstm-1.3b --smoke --rag`` on the
              card.
encdec      — encoder-decoder serving: ``whisper-medium`` at full width
              and depth (24 + 24 layers, d 1024, 16 heads of 64, GELU,
              vocab 51 865 -> 52 224, 8.116e8 bf16 parameters from seed
              0): 8 requests of 1 500 seeded frame embeddings (30 s of
              audio at 50 frames a second) and 64-token prompts through
              ``ServeEngine.generate(extra_batch={"frames": ...})``, 32
              greedy tokens from position 64, twice, identical; each
              prefill 72 flash launches on the tensor-core kernel (24
              encoder and 24 cross-attention calls without a causal mask,
              24 causal self-attention calls), each decode step 48 on the
              split-KV kernel (24 causal self, 24 cross); a loss over 8 x
              1 500 frames and 8 x 375 tokens (72 tensor-core launches,
              3 000 tokens counted).  Printed: the encoder's ms, prefill
              ms, decode ms a token, new tokens/s, peak memory.
train       — training ``minicpm-2b`` at full width and depth (40 layers,
              remat, bf16 from seed 0, float32 AdamW state) through
              ``Trainer``: ``TokenPipeline`` (vocab 122 753, T 256,
              global batch 8), ``TrainConfig(n_micro=2, peak_lr=3e-4,
              warmup=2, total_steps=10, schedule="wsd")``, 10 steps, no
              checkpoint.  Gates: every loss and grad norm finite; the
              mean of the last three losses below the first three's by
              0.2 (the reference's own bar); ``flash_attention_bwd``
              launched 40 x 2 x 10 times, every one through
              ``flash_attention_bwd_mma``, and ``flash_attention_mma``
              twice that (each block's forward again in its backward);
              every attention weight's first moment nonzero.  Printed:
              seconds a step, tokens/s, ``max_memory_allocated``, the
              backward kernel's share of a step.  Then a restart on the
              card with 2 layers at full width: 2 steps and a checkpoint
              under ``build/`` (deleted after), resumed to step 4, equal
              bit for bit to 4 uninterrupted steps; then
              ``launch.train.main`` with ``--smoke --steps 8``.
Two opt-in phases are not run by default.  ``profile`` profiles a few
build chunks at the main path's size with ``torch.profiler`` and prints
the device's busy share, device time by kernel, and the port's own
kernels' share of it.  ``trainprof`` (``--phases
build,kernels,train,trainprof``) profiles one steady step of the train
phase's model and step after an unprofiled warm-up step, and prints the
device's busy share of it, the idle time between kernels (the host's
launches), the 15 kernels with the most device time and the device time
by group: matmuls, flash forward and backward, AdamW, the float32
accumulation, copies and casts, and the microbatches' elementwise kernels
(norms, rotary, SwiGLU, the loss).

The last three lines of standard output are the card's name and power
limit (``nvidia-smi``), one JSON line of per-kernel numbers (``launches``
sums phases 4, 5, 6, filter, stream, engine, fleet, 7, moe, hybrid, vlm,
ssm, encdec and train),
and ``{"ok": true, "device": {...}}``; each phase prints its seconds, and
the line "all phases" all of them.  Without a CUDA device, or without the
repository beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "parity", "main", "ivf", "ladder", "filter",
          "stream", "engine", "fleet", "rag", "moe", "hybrid", "vlm", "ssm",
          "encdec", "train")
# the phases that build and search indexes; phase 3 reads nothing they make,
# so it runs in a child process beside them (:func:`start_parity_child`)
INDEX_PHASES = ("main", "ivf", "ladder", "filter", "stream", "engine",
                "fleet")
# host cores left to the parent's loop while the child runs phase 3 (4 made
# the smoke no shorter, PERF.md §5)
PARENT_CORES = 2
# the longest the parent waits for phase 3's child after the index phases
PARITY_WAIT_S = 600
# the share of the card's memory the parent's allocator may hold while the
# child runs: the index phases allocate ~2 GB at their peak, phase 3's LM
# checks (2-layer training of minicpm at full width among them) much more
PARENT_MEMORY_SHARE = 0.5
OPT_IN = ("profile", "trainprof")

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

    # the fleet's IVF scatter step at every probe: one shard's rows against
    # its 316 probed lists x cap 480 (its default-probe step, 106 x 480,
    # is the K = 50 880 above); logged, not in the kernels line.  Its
    # library levels (14.9 GB) are gathered when phase_times reaches it
    dim, k, b = 768, 316 * 480, 32
    table = random_table(torch, n_table, dim, seed=k)
    mask = bq.valid_mask(dim, device="cuda")
    w = mask.shape[0]
    ids = torch.randint(0, n_table, (b, k), generator=g, device="cuda",
                        dtype=torch.int32)
    q = table[torch.randint(0, n_table, (b,), generator=g, device="cuda")]
    got = kd.dist_rows(q, ids, table, mask)
    want = kd.dist_rows_plain(q, ids, table, mask)
    if not torch.equal(got, want):
        raise AssertionError(f"bq_dist_rows differs at B={b} K={k}")
    log(f"  bq_dist_rows B={b} K={k} D={dim}: exact")
    nb = torch.unique(ids).numel() * 8 * w + ids.numel() * 4 \
        + q.numel() * 4 + w * 4 + got.numel() * 4
    b_ms, b_by = bound(nb, 2 * ids.numel() * dim, INT8_OPS_PER_S)
    out[f"bq_dist_rows_k{k}"] = {
        "name": "bq_dist_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/bq_distance.cu",
        "replaces": "src/repro/kernels/bq_distance.py:25",
        "max_abs_err": float((got - want).abs().max()),
        "fns": (partial(kd.dist_rows, q, ids, table, mask),
                partial(kd.dist_rows_plain, q, ids, table, mask),
                partial(bq_library, torch, table, q, ids, mask, got)),
        "library_gathered_late": True,
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": [b, k, dim],
        "log_only": True,
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
    out.update(flash_bwd_kernels(torch))
    torch.cuda.synchronize()
    return out


def bq_library(torch, table, q, ids, mask, got):
    """``bq_dist_rows``' library call: one bmm of the gathered float32
    levels, checked to give the kernel's similarities ``got``."""
    from repro_torch.kernels import bq_distance as kd

    lr = kd.masked_levels(table, mask)[ids.long()]
    lq = kd.masked_levels(q, mask)[:, :, None]
    check_library("bq_dist_rows", torch.bmm(lr, lq)[..., 0], got)
    return partial(torch.bmm, lr, lq)


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


def visible_keys(tq, causal, q_offset, valid, window=0) -> list:
    """(first, last + 1) of each query row's visible keys."""
    out = []
    for i in range(tq):
        pos = q_offset + i
        hi = min(valid, pos + 1) if causal else valid
        lo = max(0, pos - window + 1) if window else 0
        out.append((lo, max(lo, hi)))
    return out


def flash_bound(b, tq, h, kvh, hd, causal, q_offset, valid, elem,
                window=0):
    """(ms, "bytes" or "operations") for one attention call: 4 hd flops for
    each visible (row, key) pair at the bf16 tensor-core rate, against Q,
    the visible K/V rows (those some row sees) and O moved once."""
    rows = visible_keys(tq, causal, q_offset, valid, window)
    flops = 4 * hd * sum(hi - lo for lo, hi in rows) * b * h
    span = max(hi for _, hi in rows) - min(lo for lo, _ in rows)
    nbytes = elem * hd * (2 * b * tq * h + 2 * b * kvh * span)
    return bound(nbytes, flops, TENSOR_FLOPS_PER_S)


# (label, b, tq, tk, h, kv heads, hd, q_offset, kv_valid_len, causal); each
# in float32 (the CUDA-core kernel) and bf16 (Tq = 1: split-KV; else the
# tensor-core kernel)
FLASH_CASES = [
    ("embed", 64, 64, 64, 36, 36, 64, 0, 64, True),
    ("prefill", 8, 320, 384, 36, 36, 64, 0, 320, True),
    ("decode", 8, 1, 384, 36, 36, 64, 320, 321, True),
    ("decode", 8, 1, 384, 36, 36, 64, 351, 352, True),
    # kv_valid_len before, on and after a split boundary (64 keys)
    ("decode", 8, 1, 384, 36, 36, 64, 0, 1, True),
    ("decode", 8, 1, 384, 36, 36, 64, 62, 63, True),
    ("decode", 8, 1, 384, 36, 36, 64, 63, 64, True),
    ("decode", 8, 1, 384, 36, 36, 64, 64, 65, True),
    # splits 1-3 see no key: q_offset 5 masks keys 6.. causally
    ("decode masked splits", 2, 1, 256, 8, 2, 64, 5, 200, True),
    ("decode long cache", 2, 1, 4096, 36, 36, 64, 4095, 4096, True),
    ("gqa decode group 4", 4, 1, 256, 16, 4, 64, 200, 201, True),
    ("decode hd16", 4, 1, 200, 8, 4, 16, 150, 151, True),
    ("decode hd32", 4, 1, 200, 8, 4, 32, 150, 151, True),
    ("decode hd128", 4, 1, 200, 8, 4, 128, 150, 151, True),
    ("prefill q_offset ragged", 2, 70, 256, 8, 4, 64, 100, 170, True),
    ("embed ragged", 16, 45, 45, 36, 36, 64, 0, 45, True),
    ("gqa", 2, 100, 128, 8, 2, 64, 0, 100, True),
    ("gqa decode", 4, 1, 96, 8, 2, 64, 60, 61, True),
    ("hd16", 2, 70, 70, 4, 2, 16, 0, 70, True),
    ("hd32", 2, 70, 96, 4, 4, 32, 0, 70, True),
    ("hd128", 2, 70, 70, 4, 4, 128, 0, 70, True),
    # the MoE serving shapes at head_dim 128: qwen2-moe's 16 heads (MHA) in
    # the moe phase's embed, prefill and decode; qwen3-moe's 32 heads over
    # 4 KV heads at prefill and decode
    ("qwen2 embed", 64, 64, 64, 16, 16, 128, 0, 64, True),
    ("qwen2 prefill", 8, 320, 384, 16, 16, 128, 0, 320, True),
    ("qwen2 decode", 8, 1, 384, 16, 16, 128, 320, 321, True),
    ("qwen2 decode", 8, 1, 384, 16, 16, 128, 351, 352, True),
    ("qwen3 prefill", 8, 320, 384, 32, 4, 128, 0, 320, True),
    ("qwen3 decode", 8, 1, 384, 32, 4, 128, 351, 352, True),
    # the hybrid and vlm serving shapes at head_dim 128: jamba's 32 heads
    # over 8 in the hybrid phase's embed, prefill and decode; internvl2's 16
    # over 8 in the vlm phase's prefill (256 patches + 64 tokens) and decode
    ("jamba embed", 64, 64, 64, 32, 8, 128, 0, 64, True),
    ("jamba prefill", 8, 320, 384, 32, 8, 128, 0, 320, True),
    ("jamba decode", 8, 1, 384, 32, 8, 128, 351, 352, True),
    ("internvl2 prefill", 8, 320, 384, 16, 8, 128, 0, 320, True),
    ("internvl2 decode", 8, 1, 384, 16, 8, 128, 351, 352, True),
    # the encdec serving shapes at head_dim 64, 16 heads over 16: whisper's
    # encoder over its 1 500 frames and its decoder's cross-attention over
    # them (prefill 64 tokens, decode one) without a causal mask, and its
    # causal self-attention's last decode step (64 + 31 of a 96-row cache);
    # a ragged Tq and Tk without a causal mask
    ("whisper encoder", 8, 1500, 1500, 16, 16, 64, 0, 1500, False),
    ("whisper cross prefill", 8, 64, 1500, 16, 16, 64, 0, 1500, False),
    ("whisper cross decode", 8, 1, 1500, 16, 16, 64, 0, 1500, False),
    ("whisper self decode", 8, 1, 96, 16, 16, 64, 95, 96, True),
    ("ragged non-causal", 2, 70, 130, 8, 4, 64, 0, 130, False),
]
# the labels of the served models' shapes at head_dim 128, whose checks and
# timings are logged apart
MODEL_SHAPES = ("qwen2", "qwen3", "jamba", "internvl2", "whisper")
# the cases timed in bf16 (and "embed" in float32 too), by (label,
# q_offset): the RAG path's three steps, then the served models' (qwen2-moe,
# qwen3-moe, jamba, internvl2, whisper's three non-causal calls)
FLASH_TIMED = {("embed", 0), ("prefill", 0), ("decode", 351),
               ("qwen2 embed", 0), ("qwen2 prefill", 0),
               ("qwen2 decode", 351), ("qwen3 prefill", 0),
               ("qwen3 decode", 351), ("jamba embed", 0),
               ("jamba prefill", 0), ("jamba decode", 351),
               ("internvl2 prefill", 0), ("internvl2 decode", 351),
               ("whisper encoder", 0), ("whisper cross prefill", 0),
               ("whisper cross decode", 0)}


def model_of(label: str) -> str | None:
    """The served model a flash case's label names, if any."""
    first = str(label).split()[0]
    return first if first in MODEL_SHAPES else None


def flash_record_key(variant: str, label: str) -> str:
    """A timed flash case's key among phase 2's records: the RAG path's
    embed and decode are the kernels line's entries (the variant's name);
    every other case is logged under its variant and label."""
    if label in ("embed", "decode"):
        return variant
    return f"{variant}_{label.replace(' ', '_')}"


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
    other head widths, the MoE models' shapes at head_dim 128 and strided
    cache slices, each call through the kernel its dtype and Tq select; the
    numbers at the ``FLASH_TIMED`` shapes in bf16 (the tensor-core kernel
    at embed and prefill, the split-KV decode) and the CUDA-core kernel's
    at embed in float32, with ``scaled_dot_product_attention`` on the same
    inputs as the library call."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import flash_attention as kf

    ptxas_spills()
    g = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    by_model = dict.fromkeys(MODEL_SHAPES, 0.0)  # their checks' seconds
    for label, b, tq, tk, h, kvh, hd, q_offset, valid, causal in FLASH_CASES:
        t0 = time.perf_counter()
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, tq, h, hd), generator=g, device="cuda",
                            dtype=dtype)
            k = torch.randn((b, tk, kvh, hd), generator=g, device="cuda",
                            dtype=dtype)
            v = torch.randn((b, tk, kvh, hd), generator=g, device="cuda",
                            dtype=dtype)
            kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid)
            got, err = flash_check(torch, label, q, k, v, **kw)
            variant = flash_variant(torch, q)
            log(f"  flash_attention {label} B={b} Tq={tq} Tk={tk} H={h} "
                f"K={kvh} hd={hd} q_offset={q_offset} kv_valid={valid} "
                f"causal={causal} {str(dtype)[6:]} ({variant}): max |err| "
                f"{err:.2e}")
            if (label, q_offset) not in FLASH_TIMED or (
                    dtype == torch.float32 and label != "embed"):
                continue
            # the library call: SDPA on (B, H, T, hd) views of the same
            # tensors, over the visible keys (q_offset 0 is top-left causal;
            # a decode row sees every visible key)
            qt = q.transpose(1, 2)
            kt, vt = k[:, :valid].transpose(1, 2), v[:, :valid].transpose(1, 2)
            lib = partial(sdpa, qt, kt, vt,
                          is_causal=causal and "decode" not in label,
                          enable_gqa=h != kvh)
            lib_err = float((lib().transpose(1, 2).float()
                             - got.float()).abs().max())
            if lib_err > 2e-2:
                raise AssertionError(f"SDPA disagrees with flash_attention "
                                     f"at {label} by {lib_err}")
            b_ms, b_by = flash_bound(b, tq, h, kvh, hd, causal, q_offset,
                                     valid, q.element_size())
            key = flash_record_key(variant, label)
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
                # only the RAG path's bf16 embed and decode are in the
                # kernels line (one entry a kernel); prefill, the MoE
                # shapes and the float32 kernel (no served call takes it)
                # are logged
                "log_only": key != variant or dtype == torch.float32,
            }
        if model_of(label):
            by_model[model_of(label)] += time.perf_counter() - t0
    log(f"  flash_attention at the served models' shapes (hd 128): checks "
        + ", ".join(f"{m} {t:.1f} s" for m, t in by_model.items()))
    flash_strided(torch, g)
    out.update(flash_window_kernels(torch, g))
    return out


# the instances of head width 192 must compile with no spill: ptxas's
# report (build.ptxas_report) for every kernel instanced at 192
HD192 = "Li192E"


def ptxas_spills() -> None:
    """Every hd-192 instance of the flash sources built with no spill store
    or load in ptxas's report; each one's registers logged."""
    from repro_torch.kernels import build as kbuild

    for name in ("flash_attention", "flash_attention_bwd"):
        kbuild.load(name)
        report = kbuild.ptxas_report(name)
        if not report:
            raise AssertionError(f"no ptxas report beside {name}'s library")
        found = 0
        for fn, r in sorted(report.items()):
            if HD192 not in fn:
                continue
            found += 1
            if r.get("spill_stores", 0) or r.get("spill_loads", 0):
                raise AssertionError(f"{fn} spills at hd 192: {r}")
            log(f"  ptxas {name} {fn[:60]}: {r.get('registers')} registers, "
                f"0 bytes spilled")
        if not found:
            raise AssertionError(f"{name} has no hd-192 instance")


# (label, b, tq, tk, h, kv heads, hd, q_offset, kv_valid_len, causal,
# window): nemotron-4-340b's attention (96 heads over 8 KV heads, head width
# 192) at the RAG path's three steps, and sliding windows of 128 and 1 024
# keys in prefill and decode (and at hd 192), each in float32 and bf16
# through the kernel its dtype and Tq select; every bf16 one timed beside
# its bound and SDPA's time (a boolean mask where a window applies)
FLASH_WINDOW_CASES = [
    ("nemotron embed", 64, 64, 64, 96, 8, 192, 0, 64, True, 0),
    ("nemotron prefill", 8, 320, 384, 96, 8, 192, 0, 320, True, 0),
    ("nemotron decode", 8, 1, 384, 96, 8, 192, 351, 352, True, 0),
    ("window128 prefill", 8, 320, 384, 36, 36, 64, 0, 320, True, 128),
    ("window128 decode", 8, 1, 1536, 36, 36, 64, 1200, 1201, True, 128),
    ("window1024 prefill", 2, 2048, 2048, 16, 16, 64, 0, 2048, True, 1024),
    ("window1024 decode", 8, 1, 2048, 36, 36, 64, 1999, 2000, True, 1024),
    ("window128 hd192 prefill", 2, 320, 384, 96, 8, 192, 0, 320, True, 128),
    ("window128 hd192 decode", 8, 1, 1536, 96, 8, 192, 1200, 1201, True,
     128),
]


def window_mask(torch, tq, tk, causal, q_offset, valid, window):
    """The (Tq, Tk) boolean mask of visible keys, for SDPA."""
    k_pos = torch.arange(tk, device="cuda")
    q_pos = q_offset + torch.arange(tq, device="cuda")[:, None]
    mask = k_pos < valid
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_window_kernels(torch, g) -> dict:
    """``flash_attention`` at ``FLASH_WINDOW_CASES`` against its plain
    version (float32 within 2e-3, bf16 within 2e-2; split-KV also against
    its mirror): logged, with the bf16 calls' numbers kept for phase 2's
    timing (SDPA on the same inputs, with a boolean mask, as the library
    call)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import flash_attention as kf

    out = {}
    for (label, b, tq, tk, h, kvh, hd, q_offset, valid, causal,
         window) in FLASH_WINDOW_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, tq, h, hd), generator=g, device="cuda",
                            dtype=dtype)
            k = torch.randn((b, tk, kvh, hd), generator=g, device="cuda",
                            dtype=dtype)
            v = torch.randn((b, tk, kvh, hd), generator=g, device="cuda",
                            dtype=dtype)
            kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid,
                      sliding_window=window)
            got, err = flash_check(torch, label, q, k, v, **kw)
            variant = flash_variant(torch, q)
            log(f"  flash_attention {label} B={b} Tq={tq} Tk={tk} H={h} "
                f"K={kvh} hd={hd} q_offset={q_offset} kv_valid={valid} "
                f"window={window} {str(dtype)[6:]} ({variant}): max |err| "
                f"{err:.2e}")
            if dtype == torch.float32:
                continue
            mask = window_mask(torch, tq, tk, causal, q_offset, valid,
                               window)
            lib = partial(sdpa, q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), attn_mask=mask,
                          enable_gqa=h != kvh)
            lib_err = float((lib().transpose(1, 2).float()
                             - got.float()).abs().max())
            if lib_err > 2e-2:
                raise AssertionError(f"SDPA disagrees with flash_attention "
                                     f"at {label} by {lib_err}")
            b_ms, b_by = flash_bound(b, tq, h, kvh, hd, causal, q_offset,
                                     valid, q.element_size(), window)
            out[f"{variant}_{label.replace(' ', '_')}"] = {
                "name": variant, "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:28",
                "max_abs_err": err,
                "fns": (partial(kf.flash_attention, q, k, v, **kw),
                        partial(kf.flash_attention_plain, q, k, v, **kw),
                        lib),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": [label, b, tq, tk, h, hd, q_offset, valid, window,
                          str(dtype)[6:]],
                "log_only": True,
            }
    return out


def flash_bwd_bound(b, tq, tk, h, kvh, hd, causal, q_offset, valid, elem,
                    window=0):
    """(ms, "bytes" or "operations") for one backward call: the five
    products (S again, dP, dQ, dK, dV), 2 hd flops each for every visible
    (row, key) pair, at the bf16 tensor-core rate, against q, O, dO, dQ,
    the visible K/V rows and dK, dV moved once, and for bf16 the forward's
    float32 log-sum-exp read once."""
    rows = visible_keys(tq, causal, q_offset, valid, window)
    flops = 10 * hd * sum(hi - lo for lo, hi in rows) * b * h
    span = max(hi for _, hi in rows) - min(lo for lo, _ in rows)
    nbytes = elem * hd * (4 * b * tq * h + 2 * b * kvh * span
                          + 2 * b * kvh * tk)
    if elem == 2:
        nbytes += 4 * b * h * tq
    return bound(nbytes, flops, TENSOR_FLOPS_PER_S)


# (label, b, tq, tk, h, kv heads, hd, causal, q_offset, kv_valid_len, dtype
# name, window): the train phase's attention (minicpm-2b, B 4, T 256,
# bf16), GQA at hd 128, a ragged Tq over a ragged cache at q_offset 50, one
# query row (its forward is the split-KV decode, so the backward gets the
# log-sum-exp from the tensor-core forward), hd 16 without a causal mask,
# 4096 keys, and the train shape in float32; nemotron-4-340b's attention
# at head width 192 (96 heads over 8, T 256) in both dtypes, and the train
# shape under sliding windows of 128 and 1 024 keys (T 2048 for the latter)
FLASH_BWD_CASES = [
    ("train", 4, 256, 256, 36, 36, 64, True, 0, 256, "bfloat16", 0),
    ("gqa hd128", 2, 256, 256, 56, 8, 128, True, 0, 256, "bfloat16", 0),
    ("ragged q_offset", 2, 65, 130, 4, 2, 64, True, 50, 115, "bfloat16", 0),
    ("one row", 2, 1, 90, 4, 2, 32, True, 60, 63, "bfloat16", 0),
    ("hd16 bidirectional", 2, 70, 70, 4, 4, 16, False, 0, 60, "bfloat16",
     0),
    ("long cache", 1, 128, 4096, 4, 4, 64, True, 3968, 4096, "bfloat16", 0),
    ("train float32", 4, 256, 256, 36, 36, 64, True, 0, 256, "float32", 0),
    ("nemotron hd192", 1, 256, 256, 96, 8, 192, True, 0, 256, "bfloat16",
     0),
    ("nemotron hd192 float32", 1, 256, 256, 96, 8, 192, True, 0, 256,
     "float32", 0),
    ("window128 train", 4, 256, 256, 36, 36, 64, True, 0, 256, "bfloat16",
     128),
    ("window1024 train", 1, 2048, 2048, 16, 16, 64, True, 0, 2048,
     "bfloat16", 1024),
]
# the backward cases timed: the train shape in both routes (the kernels
# line's), and nemotron's and the windows' (logged)
FLASH_BWD_TIMED = ("train", "train float32", "nemotron hd192",
                   "window128 train", "window1024 train")
# the bf16 kernel against its mirror (flash_attention_backward_mma_plain):
# |got - want| <= MIRROR_RTOL |want| + MIRROR_ATOL max|want|, element by
# element: the two round the same float32 values to bf16, reached by sums
# in another order, so an output may land one bf16 ulp (at most 2^-7 of
# itself) away; a rounding of P or dS that the order or exp2's last bit
# flips moves a gradient by a small share of the largest
MIRROR_RTOL, MIRROR_ATOL = 2.0 ** -7, 2.0 ** -9


def mirror_ratio(torch, got, want) -> float:
    """max |got - want| / (MIRROR_RTOL |want| + MIRROR_ATOL max|want|): at
    most 1 where the kernel holds to its mirror."""
    w = want.float()
    tol = MIRROR_RTOL * w.abs() + MIRROR_ATOL * float(w.abs().max())
    return float(((got.float() - w).abs() / tol.clamp_min(1e-30)).max())


def flash_bwd_kernels(torch) -> dict:
    """``flash_attention_backward`` at ``FLASH_BWD_CASES``, each call through
    the route its dtype selects (bf16: the tensor-core kernels, given the
    forward's log-sum-exp as training gives it; float32: the CUDA-core
    kernels), one launch a call: against ``flash_attention_backward_plain``
    (float32 within 1e-4, bf16 within 2^-7, of the largest gradient), bf16
    also against its mirror ``flash_attention_backward_mma_plain``
    (``MIRROR_RTOL``, ``MIRROR_ATOL``); a second call equal bit for bit (for
    bf16 without the log-sum-exp, which the wrapper then gets from the same
    forward kernel).  At the train shape the numbers of both routes, with
    SDPA's backward (``torch.autograd.grad`` on a saved graph of
    ``scaled_dot_product_attention``, within 2e-2 of the largest gradient)
    as the library call; the float32 route's are logged, not in the kernels
    line (no path launches it)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as kf

    g = torch.Generator(device="cuda").manual_seed(22)
    out = {}
    for (label, b, tq, tk, h, kvh, hd, causal, q_offset, valid,
         dname, window) in FLASH_BWD_CASES:
        dtype = getattr(torch, dname)
        q, do = (torch.randn((b, tq, h, hd), generator=g, device="cuda",
                             dtype=dtype) for _ in range(2))
        k, v = (torch.randn((b, tk, kvh, hd), generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
        kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid,
                  sliding_window=window)
        route = "mma" if dtype == torch.bfloat16 else "fma"
        if route == "mma":
            o, lse = kf.flash_attention_lse(q, k, v, **kw)
        else:
            o, lse = kf.flash_attention(q, k, v, **kw), None
        before = dict(kbuild.LAUNCHES)
        got = kf.flash_attention_backward(q, k, v, o, do, lse=lse, **kw)
        for key in (kf.BWD, kf.BWD_VARIANTS[route]):
            if kbuild.LAUNCHES[key] != before.get(key, 0) + 1:
                raise AssertionError(f"flash_attention_bwd {label} did not "
                                     f"launch {kf.BWD_VARIANTS[route]} once")
        again = kf.flash_attention_backward(q, k, v, o, do, **kw)
        want = kf.flash_attention_backward_plain(q, k, v, o, do, **kw)
        mirror = (kf.flash_attention_backward_mma_plain(q, k, v, o, do, **kw)
                  if route == "mma" else want)
        rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        err, ratio = 0.0, 0.0
        for name, a, a2, w, m in zip("qkv", got, again, want, mirror):
            if not torch.equal(a, a2):
                raise AssertionError(f"flash_attention_bwd {label}: two "
                                     f"calls differ in d{name}")
            e = float((a.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            if not e <= rel * scale or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"flash_attention_bwd {label} d{name} "
                                     f"differs by {e} (largest {scale})")
            err = max(err, e)
            if route == "mma":
                r = mirror_ratio(torch, a, m)
                if not r <= 1.0:
                    raise AssertionError(
                        f"flash_attention_bwd {label} d{name} is {r:.3f}x "
                        "its mirror's tolerance away from the mirror")
                ratio = max(ratio, r)
        # keys that no row sees: exact zeros in dK and dV
        last = min(valid, q_offset + tq) if causal else valid
        for name, a in (("k", got[1]), ("v", got[2])):
            if bool((a[:, last:] != 0).any()):
                raise AssertionError(f"flash_attention_bwd {label}: d{name} "
                                     f"of keys {last}.. no row sees is not 0")
        mirror_note = (f", against the mirror {ratio:.3f} of its tolerance"
                       if route == "mma" else "")
        log(f"  flash_attention_bwd {label} B={b} Tq={tq} Tk={tk} H={h} "
            f"K={kvh} hd={hd} causal={causal} q_offset={q_offset} "
            f"kv_valid={valid} window={window} {dname} "
            f"({kf.BWD_VARIANTS[route]}): max |err| {err:.2e}{mirror_note}, "
            "two calls identical")
        if label not in FLASH_BWD_TIMED:
            continue
        # the library call: SDPA's backward on a saved graph, (B, H, T, hd)
        leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v)]
        if window:
            lib_out = sdpa(*leaves, attn_mask=window_mask(
                torch, tq, tk, causal, q_offset, valid, window),
                enable_gqa=h != kvh)
        else:
            lib_out = sdpa(*leaves, is_causal=True, enable_gqa=h != kvh)
        lib = partial(torch.autograd.grad, lib_out, leaves,
                      do.transpose(1, 2), retain_graph=True)
        for name, a, w in zip("qkv", got, lib()):
            e = float((w.transpose(1, 2).float() - a.float()).abs().max())
            if e > 2e-2 * float(a.float().abs().max()):
                raise AssertionError(f"SDPA's backward disagrees with "
                                     f"flash_attention_bwd in d{name} by {e}")
        b_ms, b_by = flash_bwd_bound(b, tq, tk, h, kvh, hd, causal, q_offset,
                                     valid, q.element_size(), window)
        plain = (kf.flash_attention_backward_mma_plain if route == "mma"
                 else kf.flash_attention_backward_plain)
        key = kf.BWD_VARIANTS[route]
        if not label.startswith("train") or window:
            key = f"{key}_{label.replace(' ', '_')}"
        out[key] = {
            "name": kf.BWD_VARIANTS[route], "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:49",
            "max_abs_err": err,
            "fns": (partial(kf.flash_attention_backward, q, k, v, o, do,
                            lse=lse, **kw),
                    partial(plain, q, k, v, o, do, **kw), lib),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": [label, b, tq, tk, h, hd, window, dname],
            # no path launches the float32 route: logged, not in the line;
            # nemotron's and the windows' are logged too
            "log_only": route == "fma" or key != kf.BWD_VARIANTS[route],
        }
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
    by_model = dict.fromkeys(MODEL_SHAPES, 0.0)  # their timings' seconds
    for rec in kernels.values():
        t0 = time.perf_counter()
        kernel, plain, library = rec.pop("fns")
        rec["ms"], rec["stream_ms"] = time_ms(torch, kernel)
        rec["plain_ms"], rec["plain_stream_ms"] = time_ms(torch, plain,
                                                          reps=3)
        if rec.pop("library_gathered_late", False):
            # the earlier records' levels are freed by now
            library = library()
        rec["library_ms"] = time_ms(torch, library)[0] if library else None
        if rec["name"] in ("flash_attention_split_kv",
                           "flash_attention_bwd_mma"):
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
        if model_of(rec["shape"][0]):
            by_model[model_of(rec["shape"][0])] += time.perf_counter() - t0
    log("  timing flash_attention at the served models' shapes: "
        + ", ".join(f"{m} {t:.1f} s" for m, t in by_model.items()))
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


# phase 3's index corpus (cohere-surrogate) and its two probe corpora, in
# rows: 4 000 before the hybrid and vlm phases; a cut of depth, the same on
# every host, that pays for them
PARITY_N = 2000
# phase 3's files (the stream script's archive, the training checkpoint) and,
# when it runs beside the index phases, its process's log
PARITY_DIR = ROOT / "build" / "smoke" / "parity"


def phase_parity(torch) -> None:
    """The CPU and the card must agree: the index work at ``PARITY_N``
    (:func:`parity_index`), then the LMs."""
    for check in (parity_index, parity_lm, parity_moe, parity_mamba,
                  parity_jamba, parity_vlm, parity_xlstm, parity_whisper,
                  parity_train, parity_dist):
        t0 = time.perf_counter()
        check(torch)
        log(f"  {check.__name__}: {time.perf_counter() - t0:.1f} s")


def parity_index(torch) -> None:
    """The builds and searches of ``PARITY_N`` rows of cohere-surrogate on
    the CPU and on the card must agree, and every script run on them; the
    fleet on its own corpus and ``build(nav="auto")`` on ``PARITY_N`` rows
    of two."""
    import dataclasses

    import numpy as np

    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset

    base, queries = make_dataset("cohere-surrogate", PARITY_N, queries=100)
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
    parity_fleet(torch)
    for name, want in (("sift-like", "float32"), ("cohere-surrogate", "bq2")):
        parity_auto(torch, name, want, params)


def parity_filter(torch, cpu, gpu, queries) -> None:
    """The filter phase's labels and predicates on the ``PARITY_N`` graph, on
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
    """The streaming mutation script on the ``PARITY_N`` graph (with the
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
    path = PARITY_DIR / "stream.npz"
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


@contextlib.contextmanager
def recorded_routes():
    """Every MoE layer's top-k expert ids (``moe.route``'s, on the host)
    while the block runs, in call order: one (B, T, k) tensor a layer and
    a forward."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def tap(*args, **kwargs):
        routing = route(*args, **kwargs)
        seen.append(routing.expert_idx.cpu())
        return routing

    moe.route = tap
    try:
        yield seen
    finally:
        moe.route = route


def same_sets(a, b):
    """(B, T) bool: the two (B, T, k) top-k id tensors pick the same set of
    experts for the token (the order within k moves no rank: a token sends
    one pair to an expert)."""
    return (a.sort(dim=-1).values == b.sort(dim=-1).values).all(dim=-1)


# phase 3's MoE gates (PERF.md section 2): the share of (token, layer) top-k
# sets equal on the two devices, the logits of rows whose routes all agree,
# and greedy tokens where, in addition, the CPU's top-2 gap is clear
MOE_ROUTE_SHARE = 0.98
MOE_LOGIT_TOL = 0.1
MOE_CLEAR_GAP = 0.2


def parity_moe(torch) -> None:
    """``qwen2-moe-a2.7b`` at full width and 1 layer, bf16, drawn on the CPU
    and copied to the card: 2 prompts of 48 tokens, prefill and 8 greedy
    decode steps on each (the card fed the CPU's tokens).  bf16 products
    round at other places on the two devices, so a token whose k-th and
    (k+1)-th router probabilities nearly tie may pick another expert set:
    gated are the share of (token, layer) sets equal (>= 0.98), every
    logit of a row whose routes all agree (within 0.1: in a 1-layer model a
    decode row's logits follow its token's route, a prefill row's its 48
    tokens', whose ranks set the drops), and equal greedy tokens on those
    rows where the CPU's top-2 gap exceeds 0.2.  Then the capacity
    dispatch of the CPU's expert ids, of the prefill and of a 2 x 320
    scoring forward (cap 32, the served prefill's), run on the card: ranks,
    keep mask, slots and source tokens identical to the CPU's."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=1)
    bundle = build_model(cfg)
    t_all = t0 = time.perf_counter()
    cpu = bundle.init(0, device="cpu")
    gpu = tf.DecoderLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    log(f"  qwen2-moe-a2.7b x 1 layer drawn on the CPU and copied: "
        f"{time.perf_counter() - t0:.1f} s ({tf.matrix_param_count(cpu)} "
        "parameters)")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    scoring = rng.integers(0, cfg.vocab_size, (2, 320)).astype(np.int32)

    def run(model, device, feed=None):
        with recorded_routes() as routes:
            caches = bundle.init_caches(2, 64, device=device)
            logits, caches = bundle.prefill(model, {"tokens": prompts},
                                            caches)
            steps = [logits.float().cpu()]
            for i in range(8):
                tok = steps[-1].argmax(-1) if feed is None else feed[i]
                logits, caches = bundle.decode(model, tok[:, None], caches,
                                               48 + i)
                steps.append(logits.float().cpu())
        return steps, routes

    t0 = time.perf_counter()
    want, r_cpu = run(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    kbuild.reset_launches()
    t0 = time.perf_counter()
    got, r_gpu = run(gpu, "cuda", feed=[w.argmax(-1) for w in want[:-1]])
    t_gpu = time.perf_counter() - t0
    if kbuild.LAUNCHES["flash_attention"] != 9:
        raise AssertionError(f"flash_attention launched "
                             f"{kbuild.LAUNCHES['flash_attention']} times, "
                             "not 1 layer x 9 calls")
    same = [same_sets(a, b) for a, b in zip(r_cpu, r_gpu)]
    n_same = sum(int(m.sum()) for m in same)
    n_all = sum(m.numel() for m in same)
    share = n_same / n_all
    worst, compared, rows = 0.0, 0, 0
    for step, (w, gt, m) in enumerate(zip(want, got, same)):
        agree = m.all(dim=1)                 # (B,): every route of the row
        rows += int(agree.sum())
        real = w > -1e29
        diff = (gt - w).abs().masked_fill(~real, 0.0).amax(dim=1)
        if agree.any():
            worst = max(worst, float(diff[agree].max()))
        top2 = w.topk(2, dim=-1).values
        clear = agree & (top2[:, 0] - top2[:, 1] > MOE_CLEAR_GAP)
        compared += int(clear.sum())
        if not torch.equal(gt.argmax(-1)[clear], w.argmax(-1)[clear]):
            raise AssertionError(f"greedy token differs at step {step}")
    log(f"  qwen2-moe-a2.7b x 1 layer, 2 x 48 tokens, prefill + 8 decode "
        f"steps: CPU {t_cpu:.1f} s, card {t_gpu:.1f} s; (token, layer) "
        f"top-{cfg.top_k} sets equal {n_same} of {n_all} ({share:.4f}); "
        f"{rows} of 18 (row, step) pairs with every route equal: max |logit "
        f"diff| {worst:.4f}, greedy tokens equal at all {compared} with a "
        f"top-2 gap > {MOE_CLEAR_GAP}")
    if share < MOE_ROUTE_SHARE:
        raise AssertionError(f"only {share:.4f} of the (token, layer) "
                             f"routes agree (< {MOE_ROUTE_SHARE})")
    if worst > MOE_LOGIT_TOL:
        raise AssertionError(f"logits of agreeing rows differ by {worst} > "
                             f"{MOE_LOGIT_TOL}")

    # the dispatch of the CPU's routes, on the card: a 2 x 320 scoring
    # forward (cap 32) and the prefill (2 x 48, cap 8)
    with recorded_routes() as scored, torch.no_grad():
        tf.forward_hidden(cpu, tf.embed_tokens(
            cpu, torch.from_numpy(scoring).long()))
    for idx in (scored[0], r_cpu[0]):
        cap = moe.capacity(idx.shape[1], cfg.n_experts, cfg.top_k)
        a = moe.dispatch(idx, cfg.n_experts, cap)
        b = moe.dispatch(idx.cuda(), cfg.n_experts, cap)
        for name, x, y in zip(a._fields, a, b):
            if not torch.equal(x, y.cpu()):
                raise AssertionError(f"dispatch {name} of the CPU's routes "
                                     f"(T = {idx.shape[1]}) differs on the "
                                     "card")
        log(f"  dispatch of the CPU's expert ids, B 2 x T {idx.shape[1]} "
            f"(cap {cap}): ranks, keep mask, slots and source tokens "
            f"identical on the card; {int((~a.keep).sum())} of "
            f"{a.keep.numel()} pairs dropped")
    del gpu
    torch.cuda.empty_cache()
    log(f"  parity_moe: {time.perf_counter() - t_all:.1f} s")


# phase 3's mamba gate: each output, and each state after the last step,
# within 2^-5 of its largest |value| (four bf16 ulps of it) on the two
# devices (PERF.md section 2)
MAMBA_REL_TOL = 2 ** -5
# an mLSTM block's bf16 output is ill-conditioned: its head-wise norm divides
# by the RMS of a quotient whose denominator max(|q.n|, exp(-m)) can sit near
# zero, so a change of about one bf16 ulp in the block's input moves some of
# its output tokens past MAMBA_REL_TOL while its states stay within it
# (tests/test_torch_xlstm.py::test_mlstm_bf16_rounding_sensitivity).  Card
# against CPU, at most MLSTM_OUTLIER_SHARE of the (token, mLSTM block)
# outputs may pass MAMBA_REL_TOL and none MLSTM_OUTLIER_TOL; the states and
# the sLSTM's output keep MAMBA_REL_TOL
MLSTM_OUTLIER_SHARE = 0.03
MLSTM_OUTLIER_TOL = 2 ** -2


def parity_mamba(torch) -> None:
    """One ``jamba-v0.1-52b`` mamba layer at full width (d 4 096, d_inner
    8 192, d_state 16, dt_rank 256), bf16, drawn on the CPU and copied to
    the card: a prefill of 2 x 64 seeded inputs from zero states, then 8
    one-token steps, each carrying both states.  Every step's output within
    ``MAMBA_REL_TOL`` of its largest |value| on the two devices (bf16
    products round at other places), and after the last step the conv and
    float32 ssm states the same way."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import mamba

    cfg = get_config("jamba-v0.1-52b")
    t_all = time.perf_counter()
    layers = {}
    for dev in ("cpu", "cuda"):
        layers[dev] = mamba.Mamba(cfg.d_model, d_state=cfg.d_state,
                                  d_conv=cfg.d_conv, expand=cfg.ssm_expand,
                                  device=dev)
    mamba.init_mamba(layers["cpu"], generator=torch.Generator().manual_seed(0))
    layers["cuda"].load_state_dict(layers["cpu"].state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 72, cfg.d_model)).astype(np.float32)).bfloat16()
    runs = {}
    for dev, layer in layers.items():
        t0 = time.perf_counter()
        outs, conv, ssm = [], None, None
        with torch.no_grad():
            for lo, hi in [(0, 64)] + [(i, i + 1) for i in range(64, 72)]:
                out, (conv, ssm) = mamba.mamba(layer, x[:, lo:hi].to(dev),
                                               conv, ssm)
                outs.append(out.float().cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (outs, conv.float().cpu(), ssm.cpu(),
                     time.perf_counter() - t0)
    (c_outs, c_conv, c_ssm, t_cpu), (g_outs, g_conv, g_ssm, t_gpu) = \
        runs["cpu"], runs["cuda"]
    worst = 0.0
    for what, a, b in ([(f"step {i}", w, g)
                        for i, (w, g) in enumerate(zip(c_outs, g_outs))]
                       + [("conv state", c_conv, g_conv),
                          ("ssm state", c_ssm, g_ssm)]):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"mamba {what} not finite on the card")
        ratio = float((b - a).abs().max() / (MAMBA_REL_TOL * a.abs().max()))
        worst = max(worst, ratio)
        if ratio > 1.0:
            raise AssertionError(f"mamba {what} differs by {ratio:.2f} x "
                                 f"{MAMBA_REL_TOL} of its largest value")
    log(f"  jamba mamba layer at full width (d {cfg.d_model}, d_inner "
        f"{cfg.ssm_expand * cfg.d_model}), 2 x 64 prefill + 8 steps: CPU "
        f"{t_cpu:.1f} s, card {t_gpu:.1f} s; outputs and states within "
        f"{worst:.3f} of the bound (2^-5 of each one's largest |value|); "
        f"parity_mamba {time.perf_counter() - t_all:.1f} s")


# phase 3's jamba-smoke gates: in float32, the logits of rows whose routes all
# agree (every MoE layer, every step so far); in bf16, each block on the
# CPU's input and state within MAMBA_REL_TOL of its largest |value|
JAMBA_LOGIT_TOL = 1e-3


def parity_jamba(torch) -> None:
    """``jamba-v0.1-52b.smoke()`` (16 layers: 14 mamba, 2 attention, 8 MoE)
    drawn on the CPU and copied to the card, in float32 and in bf16: 2
    prompts of 48 tokens, prefill and 8 greedy decode steps (the card fed
    the CPU's tokens); ``flash_attention`` 2 layers x 9 calls.  In float32
    the whole stack is gated: the share of (token, layer) top-2 sets equal
    (>= ``MOE_ROUTE_SHARE``, ``parity_moe``'s rule), the logits of rows
    whose routes all agreed so far within ``JAMBA_LOGIT_TOL`` (the float32
    bound of the port's serving tests: the K/V caches are bf16), and equal
    greedy tokens there where the CPU's top-2 gap exceeds
    ``MOE_CLEAR_GAP``.  In bf16 a router near-tie flipped at one token
    moves that token's hidden state, which every later mamba layer carries
    to every later token of the row, so the whole stack's route share,
    logit gap and greedy tokens are printed, not gated (two bf16
    implementations of this stack differ by whole units of a logit,
    ``tests/test_torch_hybrid.py``), and each block is held on its own, on
    the CPU's input and state, by :func:`held_blocks`."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model

    cfg = get_config("jamba-v0.1-52b").smoke()
    bundle = build_model(cfg)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)

    def run(model, device, feed=None):
        steps, routes = [], []
        with recorded_routes() as seen:
            caches = bundle.init_caches(2, 64, device=device)
            logits, caches = bundle.prefill(model, {"tokens": prompts},
                                            caches)
            steps.append(logits.float().cpu())
            routes.append(list(seen))
            for i in range(8):
                tok = steps[-1].argmax(-1) if feed is None else feed[i]
                logits, caches = bundle.decode(model, tok[:, None], caches,
                                               48 + i)
                steps.append(logits.float().cpu())
                routes.append(seen[len(sum(routes, [])):])
        return steps, routes

    for dtype in (torch.float32, torch.bfloat16):
        what = f"jamba smoke ({str(dtype)[6:]})"
        t_all = time.perf_counter()
        cpu = bundle.init(0, device="cpu", dtype=dtype)
        gpu = tf.DecoderLM(cfg, device="cuda", dtype=dtype)
        gpu.load_state_dict(cpu.state_dict())
        t0 = time.perf_counter()
        want, r_cpu = run(cpu, "cpu")
        t_cpu = time.perf_counter() - t0
        feed = [w.argmax(-1) for w in want[:-1]]
        kbuild.reset_launches()
        t0 = time.perf_counter()
        got, r_gpu = run(gpu, "cuda", feed=feed)
        t_gpu = time.perf_counter() - t0
        if kbuild.LAUNCHES["flash_attention"] != 2 * 9:
            raise AssertionError(f"{what}: flash_attention launched "
                                 f"{kbuild.LAUNCHES['flash_attention']} "
                                 "times, not 2 attention layers x 9 calls")
        n_same = n_all = compared = equal = rows = 0
        worst = 0.0
        agree = torch.ones(2, dtype=torch.bool)      # every route so far
        for w, gt, rc, rg in zip(want, got, r_cpu, r_gpu):
            for a, b in zip(rc, rg):
                m = same_sets(a, b)
                n_same += int(m.sum())
                n_all += m.numel()
                agree &= m.all(dim=1)
            rows += int(agree.sum())
            real = w > -1e29
            diff = (gt - w).abs().masked_fill(~real, 0.0).amax(dim=1)
            if agree.any():
                worst = max(worst, float(diff[agree].max()))
            top2 = w.topk(2, dim=-1).values
            clear = agree & (top2[:, 0] - top2[:, 1] > MOE_CLEAR_GAP)
            compared += int(clear.sum())
            equal += int((gt.argmax(-1) == w.argmax(-1))[clear].sum())
        share = n_same / n_all
        log(f"  {what}, 2 x 48 tokens, prefill + 8 decode steps: CPU "
            f"{t_cpu:.1f} s, card {t_gpu:.1f} s; (token, layer) "
            f"top-{cfg.top_k} sets equal {n_same} of {n_all} ({share:.4f}); "
            f"{rows} of 18 (row, step) pairs with every route equal so far: "
            f"max |logit diff| {worst:.2e}, greedy tokens equal at {equal} "
            f"of {compared} with a top-2 gap > {MOE_CLEAR_GAP}")
        if dtype == torch.bfloat16:
            # printed, not gated: the whole stack carries each flip on
            gap = max(float((gt - w).abs()[w > -1e29].max())
                      for w, gt in zip(want, got))
            same = sum(int((gt.argmax(-1) == w.argmax(-1)).sum())
                       for w, gt in zip(want, got))
            log(f"  {what}, the whole stack (printed, not gated): max "
                f"|logit diff| over all 18 (row, step) pairs {gap:.4f}; "
                f"greedy tokens equal at {same} of 18")
            held_blocks(torch, what, cpu, gpu, prompts, feed)
        else:
            if share < MOE_ROUTE_SHARE:
                raise AssertionError(f"{what}: only {share:.4f} of the "
                                     f"routes agree (< {MOE_ROUTE_SHARE})")
            if equal != compared:
                raise AssertionError(f"{what}: greedy tokens differ at "
                                     f"{compared - equal} (row, step) pairs")
            if worst > JAMBA_LOGIT_TOL:
                raise AssertionError(f"{what}: logits of agreeing rows "
                                     f"differ by {worst} > "
                                     f"{JAMBA_LOGIT_TOL}")
        del gpu
        torch.cuda.empty_cache()
        log(f"  {what}: {time.perf_counter() - t_all:.1f} s")


def state_names(blk) -> tuple:
    """The names of a block's serving state, in its order."""
    from repro_torch.models import xlstm

    if hasattr(blk, "attn"):
        return ("K", "V")
    if hasattr(blk, "mamba"):
        return ("conv", "ssm")
    if isinstance(blk.cell, xlstm.MLSTM):
        return ("C", "n", "m")
    return ("c", "n", "m", "h")


def held_blocks(torch, what: str, cpu, gpu, prompts, feed) -> None:
    """Each of the card's blocks applied to the CPU's input of that block
    and the CPU's serving state of its layer, for the prefill of
    ``prompts`` and each decode step of ``feed`` (the CPU's own input and
    states carried from block to block and call to call): the output and
    the layer's state (the attention layer's K/V cache, mamba's (conv,
    ssm), an mLSTM's (C, n, m), an sLSTM's (c, n, m, h)) within
    ``MAMBA_REL_TOL`` of the CPU's largest |value| (four bf16 ulps), but
    for the tokens whose top-k set differs at an MoE block, which may be at
    most ``1 - MOE_ROUTE_SHARE`` of the (token, MoE block) pairs, and for
    an mLSTM block's output tokens, of which at most
    ``MLSTM_OUTLIER_SHARE`` of the (token, mLSTM block) pairs may pass
    ``MAMBA_REL_TOL`` and none ``MLSTM_OUTLIER_TOL``."""
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm
    from repro_torch.models.attention import KVCache

    cfg = cpu.cfg
    b = len(prompts)
    caches = tf.init_caches(cfg, b, 64, device="cpu")
    calls = [(torch.from_numpy(prompts).long(), 0)] + [
        (tok[:, None].long(), prompts.shape[1] + i)
        for i, tok in enumerate(feed)]

    def ratio(got, want) -> float:
        want = want.float()
        return float((got.float().cpu() - want).abs().max()
                     / (MAMBA_REL_TOL * want.abs().max()))

    worst, flipped, pairs = 0.0, 0, 0
    outliers, m_pairs, m_worst = 0, 0, 0.0
    with torch.no_grad():
        for tokens, pos in calls:
            x = tf.embed_tokens(cpu, tokens)
            for i, (cb, gb) in enumerate(zip(cpu.blocks, gpu.blocks)):
                state, names = caches[i], state_names(cb)
                on_card = [t.cuda() for t in state]
                on_card = KVCache(*on_card) if isinstance(state, KVCache) \
                    else tuple(on_card)
                with recorded_routes() as rc:
                    x_c, _, s_c = tf._apply_block(cb, x, cfg, cache=state,
                                                  cache_pos=pos)
                with recorded_routes() as rg:
                    x_g, _, s_g = tf._apply_block(gb, x.cuda(), cfg,
                                                  cache=on_card,
                                                  cache_pos=pos)
                keep = torch.ones(x.shape[:2], dtype=torch.bool)
                if rc:
                    keep = same_sets(rc[0], rg[0])
                    flipped += int((~keep).sum())
                    pairs += keep.numel()
                out_g, out_c = x_g.cpu()[keep], x_c[keep]
                checks = list(zip(names, s_g, s_c))
                if isinstance(getattr(cb, "cell", None), xlstm.MLSTM):
                    per_token = (out_g.float() - out_c.float()).abs() \
                        .amax(dim=-1) / out_c.float().abs().max()
                    m_worst = max(m_worst, float(per_token.max()))
                    outliers += int((per_token > MAMBA_REL_TOL).sum())
                    m_pairs += per_token.numel()
                    if not bool(torch.isfinite(out_g).all()) \
                            or m_worst > MLSTM_OUTLIER_TOL:
                        raise AssertionError(
                            f"{what} block {i} (mLSTM) output at position "
                            f"{pos} differs by {m_worst:.4f} of its largest "
                            f"value (> {MLSTM_OUTLIER_TOL})")
                else:
                    checks.insert(0, ("output", out_g, out_c))
                for name, g, c in checks:
                    if not bool(torch.isfinite(g).all()):
                        raise AssertionError(f"{what} block {i} {name} not "
                                             f"finite at position {pos}")
                    r = ratio(g, c)
                    worst = max(worst, r)
                    if r > 1.0:
                        raise AssertionError(
                            f"{what} block {i} {name} at position {pos} "
                            f"differs by {r:.2f} x {MAMBA_REL_TOL} of its "
                            "largest value")
                caches[i], x = s_c, x_c
    share = flipped / max(pairs, 1)
    log(f"  {what} block by block, {len(calls)} calls x {cfg.n_layers} "
        f"blocks on the CPU's inputs and states: outputs and states within "
        f"{worst:.3f} of the bound (2^-5 of each one's largest |value|); "
        f"{flipped} of {pairs} (token, MoE block) pairs took another "
        f"expert set ({share:.4f})")
    if share > 1 - MOE_ROUTE_SHARE:
        raise AssertionError(f"{what} blocks: {share:.4f} of the routes "
                             "differ")
    if m_pairs:
        log(f"  {what}: mLSTM outputs past 2^-5 of their largest |value| at "
            f"{outliers} of {m_pairs} (token, block) pairs "
            f"({outliers / m_pairs:.4f}; at most {MLSTM_OUTLIER_SHARE}), the "
            f"worst {m_worst:.4f} of it (at most {MLSTM_OUTLIER_TOL})")
        if outliers > MLSTM_OUTLIER_SHARE * m_pairs:
            raise AssertionError(f"{what}: {outliers} of {m_pairs} mLSTM "
                                 "outputs past 2^-5")


def parity_vlm(torch) -> None:
    """``internvl2-2b`` at full width and 2 layers, bf16, drawn on the CPU
    and copied to the card: 2 prompts of 48 tokens behind 256 seeded patch
    embeddings, prefill and 8 greedy decode steps from position 304 (the
    card fed the CPU's tokens) under ``parity_lm``'s rules (every logit
    within 0.1, equal argmax where the CPU's top-2 gap exceeds 0.2);
    ``flash_attention`` 2 layers x 9 calls; then the loss over (patches,
    tokens, labels) on both: its token count 2 x 48 on both, the loss
    within 1e-2 of the CPU's, relative."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("internvl2-2b"), n_layers=2)
    bundle = build_model(cfg)
    t_all = time.perf_counter()
    cpu = bundle.init(0, device="cpu")
    gpu = tf.DecoderLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    patches = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)) \
        .bfloat16()
    start = 48 + cfg.n_frontend_tokens

    def run(model, device, feed=None):
        batch = {"tokens": prompts, "patches": patches.to(device)}
        caches = bundle.init_caches(2, start + 16, device=device)
        logits, caches = bundle.prefill(model, batch, caches)
        steps = [logits.float().cpu()]
        for i in range(8):
            tok = steps[-1].argmax(-1) if feed is None else feed[i]
            logits, caches = bundle.decode(model, tok[:, None], caches,
                                           start + i)
            steps.append(logits.float().cpu())
        with torch.no_grad():
            loss, metrics = bundle.loss(model, {**batch, "labels": labels})
        return steps, float(loss), float(metrics["tokens"])

    t0 = time.perf_counter()
    want, l_cpu, n_cpu = run(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    kbuild.reset_launches()
    t0 = time.perf_counter()
    got, l_gpu, n_gpu = run(gpu, "cuda",
                            feed=[w.argmax(-1) for w in want[:-1]])
    t_gpu = time.perf_counter() - t0
    # 2 layers x (prefill + 8 decode steps + the loss's forward)
    if kbuild.LAUNCHES["flash_attention"] != 2 * 10:
        raise AssertionError(f"flash_attention launched "
                             f"{kbuild.LAUNCHES['flash_attention']} times, "
                             "not 2 layers x 10 calls")
    worst, compared = 0.0, 0
    for step, (w, gt) in enumerate(zip(want, got)):
        real = w > -1e29
        worst = max(worst, float((gt - w).abs()[real].max()))
        top2 = w.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 0.2
        compared += int(clear.sum())
        if not torch.equal(gt.argmax(-1)[clear], w.argmax(-1)[clear]):
            raise AssertionError(f"internvl2: greedy token differs at step "
                                 f"{step}")
    if worst > 0.1:
        raise AssertionError(f"internvl2: logits differ by {worst} > 0.1")
    if not n_cpu == n_gpu == labels.size:
        raise AssertionError(f"internvl2: the loss counted {n_cpu} / {n_gpu} "
                             f"tokens, not {labels.size}")
    if abs(l_gpu - l_cpu) > 1e-2 * abs(l_cpu):
        raise AssertionError(f"internvl2: loss {l_gpu} on the card, {l_cpu} "
                             "on the CPU")
    log(f"  internvl2-2b x 2 layers, 2 x (256 patches + 48 tokens), "
        f"prefill + 8 decode steps from position {start}: CPU {t_cpu:.1f} s, "
        f"card {t_gpu:.1f} s; max |logit diff| {worst:.4f}; greedy tokens "
        f"equal at all {compared} of 18 (row, step) pairs with a top-2 gap "
        f"> 0.2; loss {l_cpu:.5f} / {l_gpu:.5f} over {n_gpu:.0f} tokens; "
        f"parity_vlm {time.perf_counter() - t_all:.1f} s")
    del gpu
    torch.cuda.empty_cache()


# parity_xlstm's float32 gate on the logits of one period at full width
XLSTM_LOGIT_TOL = 1e-3


def parity_xlstm(torch) -> None:
    """One period of ``xlstm-1.3b`` at full width (7 mLSTM and 1 sLSTM
    block; d 2 048, d_inner 4 096, 4 heads of 1 024), drawn on the CPU and
    copied to the card: 2 prompts of 64 tokens, a prefill and 8 greedy
    decode steps with every state carried (the card fed the CPU's tokens);
    no flash launch.  In float32 the logits within ``XLSTM_LOGIT_TOL`` and
    equal greedy tokens where the CPU's top-2 gap exceeds 0.2; in bf16 the
    whole stack's logit gap printed, not gated, and each block held on the
    CPU's input and state by :func:`held_blocks` (``parity_mamba``'s
    rule: every output and state within 2^-5 of its largest |value|)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8)
    bundle = build_model(cfg)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)

    def run(model, device, feed=None):
        caches = bundle.init_caches(2, 80, device=device)
        logits, caches = bundle.prefill(model, {"tokens": prompts}, caches)
        steps = [logits.float().cpu()]
        for i in range(8):
            tok = steps[-1].argmax(-1) if feed is None else feed[i]
            logits, caches = bundle.decode(model, tok[:, None], caches,
                                           64 + i)
            steps.append(logits.float().cpu())
        return steps

    for dtype in (torch.float32, torch.bfloat16):
        what = f"xlstm-1.3b x 8 layers ({str(dtype)[6:]})"
        t_all = time.perf_counter()
        cpu = bundle.init(0, device="cpu", dtype=dtype)
        gpu = tf.DecoderLM(cfg, device="cuda", dtype=dtype)
        gpu.load_state_dict(cpu.state_dict())
        t0 = time.perf_counter()
        want = run(cpu, "cpu")
        t_cpu = time.perf_counter() - t0
        feed = [w.argmax(-1) for w in want[:-1]]
        kbuild.reset_launches()
        t0 = time.perf_counter()
        got = run(gpu, "cuda", feed=feed)
        t_gpu = time.perf_counter() - t0
        if kbuild.LAUNCHES["flash_attention"]:
            raise AssertionError(f"{what}: flash_attention launched")
        worst, compared, equal = 0.0, 0, 0
        for w, gt in zip(want, got):
            if not bool(torch.isfinite(gt[w > -1e29]).all()):
                raise AssertionError(f"{what}: logits not finite")
            worst = max(worst, float((gt - w).abs()[w > -1e29].max()))
            top2 = w.topk(2, dim=-1).values
            clear = top2[:, 0] - top2[:, 1] > 0.2
            compared += int(clear.sum())
            equal += int((gt.argmax(-1) == w.argmax(-1))[clear].sum())
        log(f"  {what}, 2 x 64 tokens, prefill + 8 decode steps: CPU "
            f"{t_cpu:.1f} s, card {t_gpu:.1f} s; max |logit diff| "
            f"{worst:.2e}; greedy tokens equal at {equal} of {compared} "
            f"(row, step) pairs with a top-2 gap > 0.2")
        if dtype == torch.bfloat16:
            held_blocks(torch, what, cpu, gpu, prompts, feed)
        elif worst > XLSTM_LOGIT_TOL or equal != compared:
            raise AssertionError(f"{what}: logits differ by {worst} (gate "
                                 f"{XLSTM_LOGIT_TOL}) or greedy tokens at "
                                 f"{compared - equal} pairs")
        del cpu, gpu
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {what}: {time.perf_counter() - t_all:.1f} s")


def parity_whisper(torch) -> None:
    """``whisper-medium`` at full width with 2 encoder and 2 decoder layers
    (d 1 024, 16 heads of 64), bf16, drawn on the CPU and copied to the
    card: 2 x 1 500 seeded frame embeddings, prompts of 16 tokens, a
    prefill and 8 greedy decode steps from position 16 (the card fed the
    CPU's tokens) under ``parity_lm``'s rules (every logit within 0.1,
    equal argmax where the CPU's top-2 gap exceeds 0.2); then the loss over
    the frames and 2 x 375 tokens: its token count equal, its value within
    1e-2 of the CPU's, relative.  ``flash_attention`` 2 x 3 times in the
    prefill and in the loss (encoder, self- and cross-attention) and 2 x 2
    a decode step."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("whisper-medium"), n_layers=2,
                              n_dec_layers=2)
    bundle = build_model(cfg)
    t_all = time.perf_counter()
    cpu = bundle.init(0, device="cpu")
    gpu = EncDecLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 1500, cfg.d_model)).astype(np.float32)).bfloat16()
    prompts = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 375)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 375)).astype(np.int32)

    def run(model, device, feed=None):
        caches = bundle.init_caches(2, 24, device=device)
        logits, caches = bundle.prefill(
            model, {"tokens": prompts, "frames": frames.to(device)}, caches)
        steps = [logits.float().cpu()]
        for i in range(8):
            tok = steps[-1].argmax(-1) if feed is None else feed[i]
            logits, caches = bundle.decode(model, tok[:, None], caches,
                                           16 + i)
            steps.append(logits.float().cpu())
        with torch.no_grad():
            loss, metrics = bundle.loss(model, {
                "frames": frames.to(device), "tokens": tokens,
                "labels": labels})
        return steps, float(loss), float(metrics["tokens"])

    t0 = time.perf_counter()
    want, l_cpu, n_cpu = run(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    kbuild.reset_launches()
    t0 = time.perf_counter()
    got, l_gpu, n_gpu = run(gpu, "cuda",
                            feed=[w.argmax(-1) for w in want[:-1]])
    t_gpu = time.perf_counter() - t0
    counts = {key: kbuild.LAUNCHES[f"flash_attention{key}"]
              for key in ("", "_mma", "_split_kv")}
    if counts != {"": 2 * 3 * 2 + 8 * 2 * 2, "_mma": 2 * 3 * 2,
                  "_split_kv": 8 * 2 * 2}:
        raise AssertionError(f"whisper: flash_attention launches {counts}")
    worst, compared = 0.0, 0
    for step, (w, gt) in enumerate(zip(want, got)):
        real = w > -1e29
        worst = max(worst, float((gt - w).abs()[real].max()))
        top2 = w.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 0.2
        compared += int(clear.sum())
        if not torch.equal(gt.argmax(-1)[clear], w.argmax(-1)[clear]):
            raise AssertionError(f"whisper: greedy token differs at step "
                                 f"{step}")
    if worst > 0.1:
        raise AssertionError(f"whisper: logits differ by {worst} > 0.1")
    if not n_cpu == n_gpu == labels.size:
        raise AssertionError(f"whisper: the loss counted {n_cpu} / {n_gpu} "
                             f"tokens, not {labels.size}")
    if abs(l_gpu - l_cpu) > 1e-2 * abs(l_cpu):
        raise AssertionError(f"whisper: loss {l_gpu} on the card, {l_cpu} "
                             "on the CPU")
    log(f"  whisper-medium x 2 + 2 layers, 2 x 1500 frames, 2 x 16 tokens, "
        f"prefill + 8 decode steps: CPU {t_cpu:.1f} s, card {t_gpu:.1f} s "
        f"(each with the loss); max |logit diff| {worst:.4f}; greedy tokens "
        f"equal at all {compared} of 18 (row, step) pairs with a top-2 gap "
        f"> 0.2; loss {l_cpu:.5f} / {l_gpu:.5f} over {n_gpu:.0f} tokens; "
        f"flash launches {counts}; parity_whisper "
        f"{time.perf_counter() - t_all:.1f} s")
    del gpu
    torch.cuda.empty_cache()


def tree_pairs(a, b, prefix=""):
    """(path, a leaf, b leaf) over two nested dict/list trees of one
    structure."""
    if isinstance(a, dict):
        for k in a:
            yield from tree_pairs(a[k], b[k], f"{prefix}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from tree_pairs(x, y, f"{prefix}/{i}")
    else:
        yield prefix, a, b


def cosine(torch, a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))


# phase 3's nemotron gate: the attention layer's outputs within this of the
# CPU's (bf16 products round at other places; parity_lm's logit bound)
NEMOTRON_TOL = 0.1
DRYRUN_DIR = ROOT / "experiments" / "dryrun_torch"


def parity_dist(torch) -> None:
    """The multi-chip substrate on the card: one ``nemotron-4-340b``
    attention layer at full width (96 heads of 192 over 8 KV heads) card
    against CPU; then, on a one-card mesh (``make_host_mesh``, NCCL and
    gloo in one world-1 group), a 2-layer full-width ``minicpm-2b`` training
    step under ``use_mesh`` against the same step without it, the same for
    a 2-layer jamba and one period of xlstm-1.3b (the recurrent cells'
    regions), a 1-layer full-width ``qwen2-moe-a2.7b`` forward through the
    MoE mesh branch, card against CPU, and the compressed all-reduce's mesh
    form against its one-controller form; then four dry-run cells,
    ``minicpm-2b x train_4k``, ``jamba-v0.1-52b x prefill_32k``,
    ``xlstm-1.3b x train_4k`` (16x16) and ``quiver-1m x 16x16``
    (``launch/dryrun.py``), printed."""
    from repro_torch.launch import mesh as mesh_mod

    t0 = time.perf_counter()
    parity_nemotron_layer(torch)
    log(f"  parity_nemotron_layer: {time.perf_counter() - t0:.1f} s")
    try:
        for check in (parity_mesh_train, parity_mesh_recurrent,
                      parity_mesh_moe, parity_mesh_compress):
            t0 = time.perf_counter()
            check(torch)
            log(f"  {check.__name__}: {time.perf_counter() - t0:.1f} s")
    finally:
        mesh_mod.close_mesh()
    t0 = time.perf_counter()
    parity_dryrun_cells(torch)
    log(f"  parity_dryrun_cells: {time.perf_counter() - t0:.1f} s")


def parity_nemotron_layer(torch) -> None:
    """One ``nemotron-4-340b`` attention layer at full width (d 18 432, 96
    heads of 192 over 8 KV heads, 7.4e8 parameters, 1.5 GB in bf16), drawn
    on the card and copied to the CPU: 2 prompts of 48 rows, prefill into a
    64-row cache, then 4 decode steps; every output within
    ``NEMOTRON_TOL`` of the CPU's (the card through the flash kernels at
    head width 192: one tensor-core launch, then one split-KV launch a
    step)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import attention as attn

    cfg = get_config("nemotron-4-340b")
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if hd != 192:
        raise AssertionError(f"nemotron's head width is {hd}, not 192")
    t0 = time.perf_counter()
    gpu = attn.Attention(d, h, kh, hd, device="cuda")
    attn.init_attention(gpu, generator=torch.Generator(
        device="cuda").manual_seed(0))
    cpu = attn.Attention(d, h, kh, hd, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    n_par = sum(p.numel() for p in cpu.parameters())
    log(f"  nemotron-4-340b attention layer ({n_par} parameters) drawn on "
        f"the card and copied: {time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 52, d), generator=g).to(torch.bfloat16)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd,
              rope_theta=cfg.rope_theta, kv_chunk=cfg.kv_chunk)

    def run(p, device):
        cache = attn.KVCache(
            torch.zeros((2, 64, kh, hd), dtype=torch.bfloat16, device=device),
            torch.zeros((2, 64, kh, hd), dtype=torch.bfloat16, device=device))
        outs = []
        with torch.no_grad():
            for pos, t in ((0, 48), (48, 1), (49, 1), (50, 1), (51, 1)):
                o, _ = attn.attention_forward(
                    p, x[:, pos:pos + t].to(device), cache=cache,
                    cache_pos=pos, **kw)
                outs.append(o.float().cpu())
        return outs

    t0 = time.perf_counter()
    want = run(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    kbuild.reset_launches()
    t0 = time.perf_counter()
    got = run(gpu, "cuda")
    t_gpu = time.perf_counter() - t0
    launches = {k: kbuild.LAUNCHES[k] for k in (
        "flash_attention_mma", "flash_attention_split_kv")}
    if launches != {"flash_attention_mma": 1, "flash_attention_split_kv": 4}:
        raise AssertionError(f"nemotron's layer launched {launches}")
    worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel = max(float((a - b).norm() / b.norm()) for a, b in zip(got, want))
    log(f"  nemotron-4-340b attention layer, 2 x 48 rows + 4 decode steps "
        f"at hd 192: CPU {t_cpu:.1f} s, card {t_gpu:.1f} s; max |out diff| "
        f"{worst:.4f} (relative L2 {rel:.2e}); launches {launches}")
    if worst > NEMOTRON_TOL:
        raise AssertionError(f"nemotron's layer differs by {worst} > "
                             f"{NEMOTRON_TOL}")
    del gpu
    torch.cuda.empty_cache()


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def parity_mesh_train(torch) -> None:
    """``minicpm-2b`` at full width and 2 layers in bf16, one training step
    (B 4, T 256, bf16 AdamW state) on the card, twice from the same draw:
    under ``use_mesh`` with the training layout (parameters, gradients and
    moments DTensors of the world-1 card mesh, attention through the
    ``local_map`` core) and without a mesh.  The loss, grad norm, every
    parameter and both moments equal bit for bit; the flash kernels
    launched alike."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=2)
    _mesh_step_pair(torch, cfg, AdamWConfig(state_dtype=torch.bfloat16),
                    b=4, t=256, label="minicpm-2b x 2 layers")


def _mesh_step_pair(torch, cfg, adamw, *, b: int, t: int,
                    label: str) -> dict:
    """One bf16 training step of ``cfg`` (B ``b``, T ``t``) on the card,
    twice from the same draw: without a mesh, then under ``use_mesh`` on
    the world-1 card mesh in the training layout.  Raises unless the loss,
    grad norm, every parameter and both moments are equal bit for bit and
    the flash kernels launched alike; returns those launches."""
    import numpy as np

    from repro_torch.dist.sharding import use_mesh
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step
    from repro_torch.train.trainer import distribute_train_state

    bundle = build_model(cfg)
    tc = TrainConfig(n_micro=1, warmup=2, adamw=adamw)
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (b, t + 1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    mesh = make_host_mesh()

    def run(meshed):
        model = bundle.init(0, device="cuda")
        opt = init_opt_state(dict(model.named_parameters()), tc.adamw)
        opt["count"] += 4
        step = make_train_step(bundle, tc)
        kbuild.reset_launches()
        t0 = time.perf_counter()
        if meshed:
            model, opt = distribute_train_state(model, opt, mesh)
            with use_mesh(mesh):
                model, opt, metrics = step(model, opt, batch)
        else:
            model, opt, metrics = step(model, opt, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kbuild.LAUNCHES.items()
                    if k.startswith("flash")}
        params = {n: _whole(p.detach()).cpu()
                  for n, p in model.named_parameters()}
        moments = {k: {n: _whole(t).cpu() for n, t in opt[k].items()}
                   for k in ("mu", "nu")}
        metrics = {k: _whole(v).cpu() for k, v in metrics.items()}
        del model, opt
        torch.cuda.empty_cache()
        return params, moments, metrics, launches, seconds

    p0, m0, met0, l0, s0 = run(False)
    p1, m1, met1, l1, s1 = run(True)
    if l0 != l1:
        raise AssertionError(f"{label}: flash launches differ: {l0} "
                             f"against {l1}")
    differ = [f"metric {k}" for k in met0 if not torch.equal(met0[k],
                                                             met1[k])]
    differ += [f"parameter {n}" for n in p0 if not torch.equal(p0[n], p1[n])]
    differ += [f"{k} {n}" for k in m0 for n in m0[k]
               if not torch.equal(m0[k][n], m1[k][n])]
    log(f"  {label}, one step of {b} x {t} under use_mesh (card mesh of "
        f"world size 1) against none: {len(p0)} parameters and both "
        f"moments compared, {len(differ)} differ; loss "
        f"{float(met0['loss']):.6f} / {float(met1['loss']):.6f}, grad norm "
        f"{float(met0['grad_norm']):.6f} / {float(met1['grad_norm']):.6f}; "
        f"step {s0:.2f} s / {s1:.2f} s; flash launches {l1}")
    if differ:
        raise AssertionError(f"{label}: the meshed step differs in "
                             f"{differ[:8]}")
    return l1


def parity_mesh_recurrent(torch) -> None:
    """The recurrent cells' ``local_map`` regions in a training step, as
    :func:`parity_mesh_train` holds the attention core: a full-width
    2-layer ``jamba-v0.1-52b`` (one mamba layer, then one attention layer,
    a dense FFN in each, so float32 AdamW state fits) and one period of
    ``xlstm-1.3b`` (7 mLSTM + 1 sLSTM layers) at full width, each one bf16
    step of 2 x 128 under ``use_mesh`` against none, equal bit for bit;
    jamba's flash forward and backward launched, alike in both."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.optim.adamw import AdamWConfig

    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=2,
                                attn_every=2, attn_offset=1, n_experts=0,
                                top_k=0)
    launches = _mesh_step_pair(torch, jamba, AdamWConfig(), b=2, t=128,
                               label="jamba-v0.1-52b x (mamba, attention)")
    if not (launches.get("flash_attention", 0) > 0
            and launches.get("flash_attention_bwd", 0) > 0):
        raise AssertionError(f"jamba's attention layer launched no flash "
                             f"forward or backward: {launches}")
    xl = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8)
    _mesh_step_pair(torch, xl, AdamWConfig(), b=2, t=128,
                    label="xlstm-1.3b x one period (7 mLSTM + 1 sLSTM)")


def parity_mesh_compress(torch) -> None:
    """The compressed all-reduce's mesh form (``compressed_psum_mesh``:
    quantize, all-gather the words and two scalars over the mesh's
    ``data`` dim, decode and sum) on the world-1 card mesh against its
    one-controller form (``compressed_psum``), over 2^24 float32 values on
    the card: equal bit for bit."""
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import compress

    mesh = make_host_mesh()
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1 << 24, generator=gen, device="cuda")
    want = compress.compressed_psum([x])[0]
    got = compress.compressed_psum_mesh(
        DTensor.from_local(x, mesh, (Partial(),), run_check=False), mesh,
        "data").to_local()
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    log(f"  compressed_psum over {x.numel()} values on the card mesh: mesh "
        f"form {'equal' if same else 'NOT equal'} to the one-controller "
        f"form bit for bit (max |sum| {float(want.abs().max()):.6f})")
    if not same:
        raise AssertionError("compressed_psum_mesh differs from "
                             "compressed_psum")


# the MoE mesh branch's float32 logits, card against CPU (jamba's float32
# serving bound)
MESH_MOE_LOGIT_TOL = 1e-3


def parity_mesh_moe(torch) -> None:
    """``qwen2-moe-a2.7b`` at full width and 1 layer in float32, drawn on
    the CPU and copied to the card, each distributed in the training layout
    on its device's world-1 mesh: one forward of 2 x 48 tokens through the
    MoE mesh branch (one flat row of 96 tokens, cap ``capacity(96)``, the
    FSDP all-gathers and the tp all-reduce over one rank).  Gated as
    ``parity_moe`` gates its routes: the share of top-4 sets equal >= 0.98
    and the dispatch of the CPU's expert ids (the flat row) identical on
    the card; the logits, where every route agrees, within
    ``MESH_MOE_LOGIT_TOL``.  In float32, because the branch is what is held
    here: in bf16 a router near-tie flips a set on either device, and one
    flip moves the ranks of the whole flat row.  The served precision is
    held after it (:func:`parity_mesh_moe_bf16`)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.dist.sharding import distribute_params, \
        param_shardings, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=1)
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    gpu = bundle.init(0, device="cuda", dtype=torch.float32)
    cpu = tf.DecoderLM(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    log(f"  qwen2-moe-a2.7b x 1 layer in float32 drawn on the card and "
        f"copied: {time.perf_counter() - t0:.1f} s")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))

    def run(model, device):
        mesh = make_host_mesh(device)
        distribute_params(model, mesh, param_shardings(mesh, model))
        with recorded_routes() as routes, torch.no_grad(), use_mesh(mesh):
            x = tf.embed_tokens(model, torch.from_numpy(tokens).to(device))
            h, aux = tf.forward_hidden(model, x)
            logits = tf.logits_from_hidden(model, h)
        return _whole(logits).float().cpu(), routes, {
            k: float(_whole(v)) for k, v in aux.items()}

    t0 = time.perf_counter()
    want, r_cpu, aux_cpu = run(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, r_gpu, aux_gpu = run(gpu, "cuda")
    t_gpu = time.perf_counter() - t0
    if len(r_cpu) != 1 or r_cpu[0].shape != (1, 96, cfg.top_k):
        raise AssertionError(f"the mesh branch routed {len(r_cpu)} rows of "
                             f"{[tuple(r.shape) for r in r_cpu]}, not one "
                             "flat row of 96 tokens")
    same = same_sets(r_cpu[0], r_gpu[0])
    share = float(same.float().mean())
    worst = float((got - want).abs().masked_fill(want < -1e29, 0).max())
    cap = moe.capacity(96, cfg.n_experts, cfg.top_k)
    a = moe.dispatch(r_cpu[0], cfg.n_experts, cap)
    b = moe.dispatch(r_cpu[0].cuda(), cfg.n_experts, cap)
    for name, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y.cpu()):
            raise AssertionError(f"dispatch {name} of the CPU's flat row "
                                 "differs on the card")
    log(f"  qwen2-moe-a2.7b x 1 layer (float32) through the MoE mesh branch, "
        f"one flat row of 2 x 48 tokens (cap {cap}): CPU {t_cpu:.1f} s, card "
        f"{t_gpu:.1f} s; top-{cfg.top_k} sets equal {int(same.sum())} of "
        f"{same.numel()} ({share:.4f}); max |logit diff| {worst:.4f}; aux "
        f"CPU {aux_cpu}, card {aux_gpu}; dispatch of the CPU's expert ids "
        f"identical on the card ({int((~a.keep).sum())} of "
        f"{a.keep.numel()} pairs dropped)")
    if share < MOE_ROUTE_SHARE:
        raise AssertionError(f"only {share:.4f} of the routes agree")
    if bool(same.all()) and worst > MESH_MOE_LOGIT_TOL:
        raise AssertionError(f"logits differ by {worst} > "
                             f"{MESH_MOE_LOGIT_TOL}")
    del gpu, cpu
    torch.cuda.empty_cache()
    parity_mesh_moe_bf16(torch, tokens)


def parity_mesh_moe_bf16(torch, tokens) -> None:
    """The MoE mesh branch at its served precision: the same layer in bf16
    (drawn on the card and copied to the CPU), the same 2 x 48 tokens, each
    device routing them twice, through the unmeshed path (two rows) and
    through the mesh branch on its world-1 mesh (one flat row).  The router
    sees the same input either way, so on each device the two top-4 sets
    of every token are equal, and the tokens whose sets differ card against
    CPU are the same through the branch as through the unmeshed path: what
    flips is a router near-tie of the bf16 hidden state (the gap between
    the k-th and (k+1)-th router probability at each such token is
    printed), not the branch.  The dispatch of the CPU's flat row is
    identical on the card."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.dist.sharding import distribute_params, \
        param_shardings, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=1)
    bundle = build_model(cfg)
    gpu = bundle.init(0, device="cuda")
    cpu = tf.DecoderLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    k = cfg.top_k

    def routes(model, device, meshed):
        """(1, 96, k) top-k ids of the flat token order, and the (96,) gap
        between the k-th and (k+1)-th router probability of each token."""
        seen, real = [], moe.route

        def tap(*args, **kwargs):
            seen.append(real(*args, **kwargs))
            return seen[-1]

        ids = torch.from_numpy(tokens).to(device)
        moe.route = tap
        try:
            with torch.no_grad(), contextlib.ExitStack() as stack:
                if meshed:
                    stack.enter_context(use_mesh(make_host_mesh(device)))
                tf.forward_hidden(model, tf.embed_tokens(model, ids))
        finally:
            moe.route = real
        if len(seen) != 1:
            raise AssertionError(f"{len(seen)} MoE routings, not one")
        top = _whole(seen[0].probs).float().topk(k + 1, dim=-1).values
        return (_whole(seen[0].expert_idx).cpu().reshape(1, -1, k),
                (top[..., k - 1] - top[..., k]).reshape(-1).cpu())

    t0 = time.perf_counter()
    plain, branch = {}, {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        plain[dev], gap_dev = routes(model, dev, False)
        if dev == "cpu":
            gap = gap_dev
        mesh = make_host_mesh(dev)
        distribute_params(model, mesh, param_shardings(mesh, model))
        branch[dev], _ = routes(model, dev, True)
        if not bool(same_sets(plain[dev], branch[dev]).all()):
            raise AssertionError(f"on {dev} the mesh branch routes other "
                                 "top-k sets than the unmeshed path")
    flips = {name: (~same_sets(r["cpu"], r["cuda"]))[0].nonzero()
             .flatten().tolist() for name, r in (("plain", plain),
                                                 ("branch", branch))}
    cap = moe.capacity(96, cfg.n_experts, k)
    a = moe.dispatch(branch["cpu"], cfg.n_experts, cap)
    b = moe.dispatch(branch["cpu"].cuda(), cfg.n_experts, cap)
    for name, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y.cpu()):
            raise AssertionError(f"dispatch {name} of the CPU's bf16 flat "
                                 "row differs on the card")
    n_same = 96 - len(flips["branch"])
    log(f"  qwen2-moe-a2.7b x 1 layer (bf16), the same 2 x 48 tokens: on "
        f"each device the mesh branch's top-{k} sets equal the unmeshed "
        f"path's (96 of 96); card against CPU {n_same} of 96 equal "
        f"({n_same / 96:.4f}), the tokens that differ {flips['branch']} "
        f"through the branch and {flips['plain']} unmeshed, their CPU "
        f"router gaps (k-th - (k+1)-th probability) "
        f"{[round(float(gap[i]), 6) for i in flips['branch']]} (median "
        f"over all 96: {float(gap.median()):.6f}); dispatch of the CPU's "
        f"flat row identical on the card; {time.perf_counter() - t0:.1f} s")
    if flips["branch"] != flips["plain"]:
        raise AssertionError("card against CPU, the mesh branch flips other "
                             "tokens than the unmeshed path")
    del gpu
    torch.cuda.empty_cache()


def parity_dryrun_cells(torch) -> None:
    """Four dry-run cells (``launch/dryrun.py``), printed with their
    roofline terms and seconds: ``minicpm-2b x train_4k``, ``jamba-v0.1-52b
    x prefill_32k`` and ``xlstm-1.3b x train_4k`` at full size on the fake
    16x16 mesh (fake CUDA tensors; the recurrent cells priced, not run over
    T), and ``quiver-1m`` (one 4 096-row shard of the 1M x 768 index built
    and searched on the card)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import close_mesh

    reports = []
    try:
        for arch, shape in (("minicpm-2b", "train_4k"),
                            ("jamba-v0.1-52b", "prefill_32k"),
                            ("xlstm-1.3b", "train_4k")):
            reports.append(dryrun.run_cell(arch, shape, False, DRYRUN_DIR,
                                           time_limit=300.0))
        reports.append(dryrun.run_quiver_cell(False, DRYRUN_DIR))
    finally:
        close_mesh()
    for rep in reports:
        if "error" in rep:
            raise AssertionError(f"dry-run cell {rep['cell']}: "
                                 f"{rep['error']}")
        t = rep["terms_seconds"]
        log(f"  dry run {rep['cell']} ({rep['mode']}): flops/dev "
            f"{rep['flops_per_device']:.3e}, bytes/dev "
            f"{rep['bytes_per_device']:.3e}, collective bytes/dev "
            f"{rep['collectives']['total_bytes']:.3e}; compute "
            f"{t['compute']:.4e} s, memory {t['memory']:.4e} s, collective "
            f"{t['collective']:.4e} s: {rep['dominant']}-bound at "
            f"{rep['bound_seconds']:.4e} s, useful flops "
            f"{rep['useful_flops_ratio']:.3f}, MFU at the bound "
            f"{rep['mfu_at_bound']:.4f}; traced in "
            f"{rep['compile_seconds']} s")


def parity_train(torch) -> None:
    """Training, CPU against card: ``minicpm-2b`` at full width and 2 layers
    in bf16, the same parameters (drawn on the card, copied to the CPU) and
    batch (B 2, S 64), one ``make_train_step`` step each with bf16 AdamW
    state.  The loss and grad norm within 1e-2 relative; the gradients,
    read from the first moment (``mu = 0.1 g`` clipped, one step from zero,
    in bf16), at a relative L2 within 5e-2 of the CPU's leaf by leaf (bf16
    products round at other places, the card's forward rounds P to bf16),
    every attention weight's nonzero; the backward kernel launched once a
    layer; each matrix's update at cosine >= 0.9 with the CPU's.  Then the
    card's state saved as a checkpoint (the trainer's tree and format,
    every matrix and moment a bf16 leaf) under ``build/`` and restored on
    the CPU: every leaf equal to the card's, bit for bit, and loaded into
    the CPU's model and optimizer state; the checkpoint is deleted."""
    import dataclasses
    import shutil

    import numpy as np

    from repro_torch import convert
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=2)
    bundle = build_model(cfg)
    gpu = bundle.init(0, device="cuda")
    cpu = DecoderLM(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(22)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()
              if p.ndim >= 2}
    tc = TrainConfig(peak_lr=1e-3, warmup=0, total_steps=10,
                     adamw=AdamWConfig(state_dtype=torch.bfloat16))
    step = make_train_step(bundle, tc)
    stepped = []
    for model in (cpu, gpu):
        kbuild.reset_launches()
        opt = init_opt_state(dict(model.named_parameters()), tc.adamw)
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, batch)
        stepped.append((opt, metrics, time.perf_counter() - t0))
    (c_opt, c_m, c_s), (g_opt, g_m, g_s) = stepped
    if not (kbuild.LAUNCHES["flash_attention_bwd"]
            == kbuild.LAUNCHES["flash_attention_bwd_mma"] == cfg.n_layers):
        raise AssertionError("the card's backward did not launch "
                             "flash_attention_bwd_mma once a layer")
    for key in ("loss", "grad_norm"):
        if abs(g_m[key].item() / c_m[key].item() - 1) > 1e-2:
            raise AssertionError(f"train step {key}: CPU {c_m[key].item()} "
                                 f"card {g_m[key].item()}")
    worst_g, worst_u = 0.0, 1.0
    g_params = dict(gpu.named_parameters())
    for n, p in cpu.named_parameters():
        want, got = c_opt["mu"][n].float(), g_opt["mu"][n].cpu().float()
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        worst_g = max(worst_g, rel)
        if rel > 5e-2:
            raise AssertionError(f"gradient {n} at relative L2 {rel}")
        if ".attn." in n and not bool((got != 0).any()):
            raise AssertionError(f"gradient {n} is zero on the card")
        if n in before:
            c = cosine(torch, g_params[n].detach().cpu().float()
                       - before[n].float(), p.detach().float()
                       - before[n].float())
            worst_u = min(worst_u, c)
            if c < 0.9:
                raise AssertionError(f"update of {n} at cosine {c}")
    log(f"  train parity, minicpm-2b x 2 layers, B 2 x S 64, one step: "
        f"CPU {c_s:.1f} s, card {g_s:.2f} s; loss CPU "
        f"{c_m['loss'].item():.5f} card {g_m['loss'].item():.5f}, grad "
        f"norm {c_m['grad_norm'].item():.4f} / "
        f"{g_m['grad_norm'].item():.4f}; gradients at relative L2 <= "
        f"{worst_g:.2e}; updates at cosine >= {worst_u:.4f}")
    del before, stepped, c_opt
    path = PARITY_DIR / "ckpt"
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    state = {"params": convert.lm_params_to_numpy(gpu, keep_bf16=True),
             "opt": convert.opt_state_to_numpy(g_opt, gpu, keep_bf16=True)}
    checkpoint.save(str(path), state, step=1)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, at = checkpoint.restore(str(path),
                                      convert.train_state_like(cpu, g_opt))
    convert.load_lm_params(cpu, restored["params"])
    c_opt = convert.opt_state_from_numpy(restored["opt"], cpu)
    t_load = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in path.iterdir())
    shutil.rmtree(path)
    for key, a, b in tree_pairs(state, restored):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"checkpoint leaf {key} differs")
    for n, p in cpu.named_parameters():
        if not torch.equal(p, g_params[n].cpu()) or not torch.equal(
                c_opt["nu"][n], g_opt["nu"][n].cpu()):
            raise AssertionError(f"{n} or its moment differs once loaded")
    if at != 1 or int(c_opt["count"]) != 1 or \
            state["params"]["embed"]["w"].dtype != torch.bfloat16:
        raise AssertionError("checkpoint step or bf16 leaves lost")
    log(f"  checkpoint of the card's state ({size} bytes) saved in "
        f"{t_save:.1f} s, restored on the CPU in {t_load:.1f} s: every "
        "leaf identical, bf16 kept")


def parity_auto(torch, name: str, want: str, params) -> None:
    """``build(nav="auto")`` over ``PARITY_N`` rows of ``name`` on the CPU
    and on the card: the same report verdict and policy, and ids matched by
    ``ids_match``."""
    import dataclasses

    from repro_torch.core.index import QuIVerIndex
    from repro_torch.data.datasets import make_dataset

    base, queries = make_dataset(name, PARITY_N, queries=100)
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


def fleet_fields(fleet) -> dict:
    """A fleet's stacked fields on the host (``convert.sharded_to_numpy``)
    without the cold vectors, which each device normalizes in its own
    float order."""
    from repro_torch import convert

    out = convert.sharded_to_numpy(fleet)
    out.pop("vectors")
    return out


def same_fields(a: dict, b: dict, what: str) -> None:
    import numpy as np

    if a.keys() != b.keys():
        raise AssertionError(f"{what}: fields {sorted(a)} vs {sorted(b)}")
    for key in a:
        if not np.array_equal(a[key], b[key]):
            raise AssertionError(f"{what}: {key} differs")


def parity_fleet(torch) -> None:
    """The fleet on ``device="cpu"`` and on the card, at N = 2 003 of
    cohere-surrogate over 4 shards (one pad row): ``build_sharded`` with 2
    labels (every stacked field but the cold vectors identical), the
    fan-out unfiltered and with label 0 (ids identical where the scores
    separate them, scores within 1e-6), ``build_ivf_sharded`` (placement
    identical) and its targeted and broadcast scatter (ids identical), and
    one ``StreamingShardedIndex`` script (``empty(n_shards=3)``, insert
    1 200 with the labels, delete 150 with shard 1's medoid, consolidate,
    insert 100, fan-out, ``enable_ivf_routing``, scatter): every shard's
    state and every id identical."""
    import numpy as np

    from repro_torch.core import distributed as dist
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.stream import StreamingShardedIndex

    n = 2003
    base, queries = make_dataset("cohere-surrogate", n, queries=100)
    # small graphs: the CPU side of these builds is phase 3's cost
    params = BuildParams(m=6, ef_construction=32, prune_pool=32, chunk=128)
    rng = np.random.default_rng(0)
    labels = label_rows(np.stack([rng.random(n) < p for p in (0.5, 0.1)],
                                 axis=1))
    runs = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        fleet = dist.build_sharded(base, 4, params, labels=labels,
                                   n_labels=2, label_entry_min=16,
                                   device=dev)
        # label 0 (half the rows) widens ef to 128; label 1's 640 would
        # cover each 501-row shard whole, at a high cost on the CPU
        searches = [dist.search_sharded(fleet, queries, k=10, ef=64, **kw)
                    for kw in ({}, {"filter": 0})]
        ivf = dist.build_ivf_sharded(base, 4, seed=0, device=dev)
        scatter = [dist.search_ivf_sharded(ivf, queries, k=10, ef=64,
                                           broadcast=b,
                                           registry=MetricsRegistry())
                   for b in (False, True)]
        stream = StreamingShardedIndex.empty(
            base.shape[1], n_shards=3, capacity_per_shard=600,
            params=params, n_labels=2, device=dev)
        gids = stream.insert(base[:1200], labels=labels[:1200])
        dead = np.r_[stream.shards[1].medoid + 600, gids[:149]]
        stream.delete(dead)
        stream.consolidate()
        reused = stream.insert(base[1200:1300], labels=labels[1200:1300])
        fan = stream.search(queries, k=10, ef=64)
        stream.enable_ivf_routing(seed=0)
        scat = stream.search(queries, k=10, ef=64, scatter=True,
                             registry=MetricsRegistry())
        runs[dev] = (fleet, searches, ivf, scatter, stream, gids, reused,
                     fan, scat)
        log(f"  {dev}: fleet build + searches, IVF fleet, streaming fleet "
            f"{time.perf_counter() - t0:.1f} s; shard medoids "
            f"{fleet.medoids.tolist()}")
    cpu, gpu = runs["cpu"], runs["cuda"]
    same_fields(fleet_fields(cpu[0]), fleet_fields(gpu[0]),
                "build_sharded, CPU against card")
    tied = 0
    pairs = list(zip(cpu[1], gpu[1])) + list(zip(cpu[3], gpu[3])) \
        + [(cpu[7], gpu[7]), (cpu[8], gpu[8])]
    for (c_ids, c_scores), (g_ids, g_scores) in pairs:
        if not np.allclose(c_scores, g_scores, rtol=0, atol=1e-6):
            raise AssertionError("fleet scores differ between CPU and card")
        tied += ids_match(c_ids, g_ids, c_scores, g_scores)
    for field in ("list_shard", "list_local"):
        if not np.array_equal(getattr(cpu[2], field), getattr(gpu[2], field)):
            raise AssertionError(f"IVF fleet {field} differs")
    for c_sh, g_sh in zip(cpu[2].shards, gpu[2].shards):
        if not (np.array_equal(c_sh.ids, g_sh.ids)
                and torch.equal(c_sh.list_ids, g_sh.list_ids.cpu())
                and torch.equal(c_sh.sig_words, g_sh.sig_words.cpu())):
            raise AssertionError("IVF fleet placement differs")
    for c_mut, g_mut in zip(cpu[4].shards, gpu[4].shards):
        assert_same_stream_state(torch, stream_state(c_mut),
                                 stream_state(g_mut),
                                 "streaming fleet, CPU against card")
    if not (np.array_equal(cpu[5], gpu[5]) and np.array_equal(cpu[6],
                                                              gpu[6])):
        raise AssertionError("streaming fleet gids differ")
    same_fields(fleet_fields(cpu[4].snapshot()),
                fleet_fields(gpu[4].snapshot()),
                "streaming fleet snapshot, CPU against card")
    log(f"  fleet: build_sharded fields, IVF placement and the streaming "
        f"fleet's state identical; {len(pairs)} searches' ids identical up "
        f"to {tied} rows of scores within 1e-6")


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


# phase 5's IVF-seeded build runs over the first 20 000 rows of the phase-4
# corpus on every host, a cut of depth that pays for the moe phase and
# phase 3's MoE parity (its linking took 154 s at 100 000 rows; at 50 000,
# 74.6 s) and, at 20 000, for phase 2's hd-192 and window checks and phase
# 3's multi-chip checks (PERF.md §5); the filter and engine phases search
# this index
IVF_N = 20_000


def build_ivf_index(base):
    """The IVF-seeded index over the first ``IVF_N`` rows of ``base``."""
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams

    return QuIVerIndex.build(base[:IVF_N], BuildParams(ivf_candidates=True),
                             device="cuda")


def phase_ivf(torch) -> dict:
    """The IVF path at deployment size (over the first ``IVF_N`` rows);
    returns its launch counts."""
    import numpy as np

    from repro_torch.core.baselines import flat_search, recall_at_k
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.data.datasets import make_dataset
    from repro_torch.ivf import build_partition
    from repro_torch.kernels import build as kbuild

    n, n_queries = IVF_N, 1000
    base, queries = make_dataset("cohere-surrogate", 100_000,
                                 queries=n_queries)
    truth, _ = flat_search(base[:n], queries, 10, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kbuild.reset_launches()
    t0 = time.perf_counter()
    index = build_ivf_index(base)
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


# phase 6's bq1 build runs over the first 25 000 rows on every host, a cut
# of depth that pays for the fleet phase (its searches and probes stay at
# 100 000)
LADDER_BQ1_N = 25_000


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
        ivf_index = build_ivf_index(base)
        ivf_truth, _ = flat_search(base[:IVF_N], queries, 10, device="cuda")
        ivf_recall = recall_at_k(
            ivf_index.search(queries, k=10, ef=128, nav="ivf")[0], ivf_truth)
    torch.cuda.synchronize()
    t_phase = time.perf_counter()

    kbuild.reset_launches()
    rng = np.random.default_rng(0)
    member = np.stack([rng.random(n) < p for p in FILTER_RATES], axis=1)
    rows = label_rows(member)
    graph.attach_labels(rows, n_labels=len(FILTER_RATES))
    # phase 5's index holds the first IVF_N rows, with their labels
    ivf_index.attach_labels(rows[:IVF_N], n_labels=len(FILTER_RATES))
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
        rows_n = IVF_N if on_ivf else n
        plan, ctx = resolve_plan(index, k=10, ef=64, filter=pred, **kw)
        mask = mask_of(member[:rows_n]) if mask_of is not None else None
        if mask is not None:
            want_ids, want_scores = filtered_truth(base[:rows_n], queries,
                                                   mask)
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
        if ids.shape != (n_queries, 10) or ids.max() >= rows_n:
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
# (benchmarks/streaming.py: 5% of the corpus a cycle); one cycle, a fixed
# cut of depth on every host (two cycles cost ~30 s more and the train
# phase needs the time)
STREAM_CHURN, STREAM_CYCLES = 0.05, 1


def timed_call(torch, label: str, fn, count=None):
    """``fn()`` and its seconds (synchronized), logged with ``count`` a
    second where a count is given."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rate = f", {count / secs:.1f} a second" if count else ""
    log(f"  {label}: {secs:.3f} s{rate}")
    return out, secs


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

    timed = partial(timed_call, torch)
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
        ivf_index = build_ivf_index(base)
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


# the fleet phase: 4 graph shards over a fixed cut of phase 4's corpus
# (6 251 rows a shard, one pad row in shard 3, above DESIGN.md §3's 3 906
# a chip), the IVF scatter at the full N, and 5% churn on the graph shards
FLEET_N = 25_003
FLEET_SHARDS = 4
FLEET_RATES = (0.5, 0.1, 0.02, 0.005)
FLEET_CHURN = 0.05


def phase_fleet(torch, main: dict | None) -> dict:
    """The sharded fleet on phase 4's corpus (made here when phase 4 did
    not run): ``build_sharded`` over the first ``FLEET_N`` rows in
    ``FLEET_SHARDS`` shards with 4 labels, the fan-out unfiltered and
    filtered; ``build_ivf_sharded`` and its targeted scatter at the full
    N; the graph shards adopted as a ``StreamingShardedIndex`` under 5%
    churn and an IVF routing tier.  Returns the phase's launch counts."""
    import numpy as np

    from repro_torch.core import bq
    from repro_torch.core import distributed as dist
    from repro_torch.core.baselines import flat_search, recall_at_k
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.data.datasets import make_dataset
    from repro_torch.filter import Any
    from repro_torch.kernels import build as kbuild
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.stream import MutableQuIVerIndex, StreamingShardedIndex

    if main is not None:
        base, queries, truth = main["data"]
    else:
        base, queries = make_dataset("cohere-surrogate", 100_000,
                                     queries=1000)
        truth, _ = flat_search(base, queries, 10, device="cuda")
    n, nq, n_sh = FLEET_N, len(queries), FLEET_SHARDS
    sub = base[:n]
    sub_truth, _ = flat_search(sub, queries, 10, device="cuda")
    t_phase = time.perf_counter()
    failures = []
    kbuild.reset_launches()

    # 1. the graph fleet
    rng = np.random.default_rng(0)
    member = np.stack([rng.random(n) < p for p in FLEET_RATES], axis=1)
    fleet, _ = timed_call(
        torch, f"build_sharded N={n} over {n_sh} shards, 4 labels",
        lambda: dist.build_sharded(sub, n_sh, BuildParams(),
                                   labels=label_rows(member),
                                   n_labels=len(FLEET_RATES),
                                   label_entry_min=32, device="cuda"))
    per = fleet.n_per_shard
    for s, st in enumerate(fleet.build_stats):
        hot = sum(t.numel() * 4 for t in (fleet.sig_words[s],
                                          fleet.adjacency[s],
                                          fleet.label_words[s]))
        log(f"    shard {s}: build {st.seconds:.1f} s, {st.chunks} chunks, "
            f"mean hops {st.mean_hops:.1f}, medoid {fleet.medoids[s]}, "
            f"{hot} hot bytes")
    n_live = sum(int(m.sum()) for m in fleet.live)
    if n_live != n:
        failures.append(f"fleet: {n_live} live rows, not {n}")
    tail, _ = dist.search_sharded(fleet, sub[n - 3:], k=1, ef=64)
    if tail.ravel().tolist() != list(range(n - 3, n)):
        failures.append(f"fleet: the tail rows came back as "
                        f"{tail.ravel().tolist()}")
    (ids, _), secs = timed_call(
        torch, f"fan-out search {nq} queries at k=10 ef=64",
        lambda: dist.search_sharded(fleet, queries, k=10, ef=64), nq)
    fleet_ids = ids
    recall = recall_at_k(ids, sub_truth)
    log(f"    recall@10 {recall:.4f} against exact cosine over {n} rows")
    if ids.min() < 0 or ids.max() >= n:
        failures.append("fleet: an id out of [0, N) (a pad row?)")
    if any(len(set(row.tolist())) != len(row) for row in ids):
        failures.append("fleet: a row repeats an id")
    if recall < 0.80:
        failures.append(f"fleet: recall@10 {recall:.4f} < 0.80")
    for name, pred, mask in (("label 1", 1, member[:, 1]),
                             ("Any(2, 3)", Any(2, 3),
                              member[:, 2] | member[:, 3])):
        (f_ids, _), _ = timed_call(
            torch, f"fan-out search {nq} queries, filter {name} "
            f"({mask.mean():.4f} of rows)",
            lambda: dist.search_sharded(fleet, queries, k=10, ef=64,
                                        filter=pred), nq)
        ok = f_ids[f_ids >= 0]
        if not mask[ok].all():
            failures.append(f"fleet {name}: an id outside the predicate")
        gt, _ = filtered_truth(sub, queries, mask)
        r = recall_at_k(f_ids, gt)
        log(f"    recall@10 against the filtered truth {r:.4f}")
        if r < recall - 0.05:
            failures.append(f"fleet {name}: recall {r:.4f} < {recall:.4f} "
                            "- 0.05")

    # 2. the IVF targeted scatter at the full N
    ivf, _ = timed_call(torch, f"build_ivf_sharded N={len(base)} over "
                        f"{n_sh} shards",
                        lambda: dist.build_ivf_sharded(base, n_sh, seed=0,
                                                       device="cuda"))
    sizes = [sh.ids.size for sh in ivf.shards]
    owned = np.sort(np.concatenate([sh.lists for sh in ivf.shards]))
    p = ivf.default_probes
    log(f"    {ivf.n_lists} lists, default probes {p}; shard sizes "
        f"{sizes}, lists {[sh.lists.size for sh in ivf.shards]}, list caps "
        f"{[sh.list_ids.shape[1] for sh in ivf.shards]}")
    if sum(sizes) != len(base):
        failures.append(f"ivf fleet: shard sizes sum to {sum(sizes)}")
    if not np.array_equal(owned, np.arange(ivf.n_lists)):
        failures.append("ivf fleet: a list is on no shard or on two")
    runs = {}
    for label, broadcast in (("targeted", False), ("broadcast", True)):
        reg = MetricsRegistry()
        (out, secs) = timed_call(
            torch, f"{label} scatter {nq} queries at k=10 ef=64, {p} probes",
            lambda: dist.search_ivf_sharded(ivf, queries, k=10, ef=64,
                                            broadcast=broadcast,
                                            registry=reg), nq)
        runs[label] = (out, reg)
    (t_ids, t_scores), reg = runs["targeted"]
    (b_ids, b_scores), _ = runs["broadcast"]
    if not (np.array_equal(t_ids, b_ids)
            and np.allclose(t_scores, b_scores, rtol=0, atol=1e-6)):
        failures.append("ivf fleet: targeted ids differ from broadcast's")
    contacted = reg.histogram("quiver_ivf_scatter_shards")
    routes = reg.snapshot()["quiver_ivf_list_routes_total"]
    log(f"    contacted shards a query: "
        f"{reg.snapshot()['quiver_ivf_scatter_shards']['']}; max "
        f"{contacted.percentile(100)}; routes {sum(routes.values())}")
    if contacted.percentile(100) > min(p, n_sh):
        failures.append("ivf fleet: a query contacted more than min(p, S)")
    if sum(routes.values()) != nq * p:
        failures.append(f"ivf fleet: {sum(routes.values())} routes, not "
                        f"{nq * p}")
    (full_ids, _), _ = timed_call(
        torch, f"targeted scatter {nq} queries at k=10 ef=256, all "
        f"{ivf.n_lists} probes",
        lambda: dist.search_ivf_sharded(ivf, queries, k=10, ef=256,
                                        probes=ivf.n_lists,
                                        registry=MetricsRegistry()), nq)
    r_ivf = recall_at_k(full_ids, truth)
    log(f"    recall@10 {r_ivf:.4f} at full probes (default probes: "
        f"{recall_at_k(t_ids, truth):.4f})")
    if r_ivf < 0.9:
        failures.append(f"ivf fleet: full-probe recall {r_ivf:.4f} < 0.9")
    del ivf, runs

    # 3. the graph shards adopted as a streaming fleet (2x headroom, the
    # pad row tombstoned): nothing is built twice
    cap = 2 * per
    shards = []
    for s in range(n_sh):
        mut = MutableQuIVerIndex.from_index(QuIVerIndex(
            sigs=bq.Signature(words=fleet.sig_words[s], dim=fleet.dim),
            adjacency=fleet.adjacency[s], medoid=int(fleet.medoids[s]),
            params=BuildParams(),
            vectors=fleet.vectors[s]), capacity=cap)
        pad = np.nonzero(~fleet.live[s].cpu().numpy())[0]
        if pad.size:
            mut.delete(pad)
        shards.append(mut)
    stream = StreamingShardedIndex(shards)
    monitors = stream.attach_drift_monitors(tenant="fleet",
                                            registry=MetricsRegistry())
    # the row of ``sub`` each global id holds (-1: none, or a pad row)
    gid_row = np.full(n_sh * cap, -1, dtype=np.int64)
    for s in range(n_sh):
        rows = s * per + np.arange(per)
        gid_row[s * cap + np.arange(per)] = np.where(rows < n, rows, -1)

    def rows_of(ids):
        return np.where(ids >= 0, gid_row[np.maximum(ids, 0)], -1)

    def live_gids():
        return np.concatenate([s * cap + np.nonzero(m.live)[0]
                               for s, m in enumerate(stream.shards)])

    def live_truth_rows():
        rows = gid_row[live_gids()]
        ids, _ = flat_search(sub[rows], queries, 10, device="cuda")
        return rows[ids]

    def gated(step, dead, gt, ef=64):
        (got, _), _ = timed_call(torch, f"{step}: search {nq} queries at "
                                 f"ef {ef}", lambda: stream.search(
                                     queries, k=10, ef=ef), nq)
        if dead is not None and np.isin(got, dead).any():
            failures.append(f"stream fleet {step}: a deleted id returned")
        r = recall_at_k(rows_of(got), gt)
        log(f"    recall@10 {r:.4f}")
        return got, r

    (z_ids, _), _ = timed_call(torch, f"stream fleet, zero churn: search "
                               f"{nq} queries", lambda: stream.search(
                                   queries, k=10, ef=64), nq)
    want = np.where(fleet_ids >= 0,
                    (fleet_ids // per) * cap + fleet_ids % per, -1)
    if not np.array_equal(z_ids, want):
        failures.append("stream fleet: zero-churn ids differ from the "
                        "graph fleet's, slot for slot")
    n_churn = int(FLEET_CHURN * n)
    dead = np.random.default_rng(0).choice(live_gids(), n_churn,
                                           replace=False)
    rows = gid_row[dead]
    gone, _ = timed_call(torch, f"delete {n_churn}",
                         lambda: stream.delete(dead), n_churn)
    if gone != n_churn:
        failures.append(f"stream fleet: {gone} of {n_churn} deleted")
    gt = live_truth_rows()
    _, r_before = gated("after delete", dead, gt)
    reclaimed = 0
    for i, mut in enumerate(stream.shards):
        rep, _ = timed_call(torch, f"consolidate shard {i}",
                            mut.consolidate)
        log(f"    {rep['repaired_rows']} rows repaired, {rep['reclaimed']} "
            "slots reclaimed")
        reclaimed += rep["reclaimed"]
    if reclaimed != n_churn + n_sh * per - n:
        failures.append(f"stream fleet: {reclaimed} slots reclaimed")
    _, r_after = gated("after consolidate", dead, gt)
    if r_after < r_before - 0.02:
        failures.append(f"stream fleet: recall after consolidate "
                        f"{r_after:.4f} < {r_before:.4f} - 0.02")
    before = set(live_gids().tolist())
    new, _ = timed_call(torch, f"re-insert {n_churn}",
                        lambda: stream.insert(sub[rows]), n_churn)
    if len(set(new.tolist())) != n_churn or before & set(new.tolist()):
        failures.append("stream fleet: re-inserted gids not unique")
    gid_row[new] = rows
    ef_bar = BuildParams().ef_construction
    (hit, _), _ = timed_call(torch, f"self search of the {n_churn} at k=1, "
                             f"ef {ef_bar}", lambda: stream.search(
                                 sub[rows], k=1, ef=ef_bar), n_churn)
    share = float((hit[:, 0] == new).mean())
    log(f"    found at k=1: {share:.4f}")
    if share <= 0.9:
        failures.append(f"stream fleet: self-hit {share:.4f} at ef {ef_bar}")
    fan_ids, r_fan = gated("after re-insert", None, sub_truth)
    n_lists, _ = timed_call(torch, "enable_ivf_routing",
                            stream.enable_ivf_routing)
    (sc_ids, _), _ = timed_call(
        torch, f"scatter search {nq} queries, all {n_lists} probes",
        lambda: stream.search(queries, k=10, ef=64, scatter=True,
                              probes=n_lists, registry=MetricsRegistry()),
        nq)
    r_sc = recall_at_k(rows_of(sc_ids), sub_truth)
    log(f"    recall@10 {r_sc:.4f} (fan-out {r_fan:.4f}); rows identical "
        f"to the fan-out's: {float((sc_ids == fan_ids).all(axis=1).mean()):.4f}")
    if r_sc < r_fan - 0.01:
        failures.append(f"stream fleet: scatter recall {r_sc:.4f} < "
                        f"{r_fan:.4f} - 0.01")
    kill = sc_ids[0, :3]
    stream.delete(kill)
    (sc2, _), _ = timed_call(
        torch, f"scatter search {nq} queries after one more delete (the "
        "lazy rebuild)", lambda: stream.search(
            queries, k=10, ef=64, scatter=True, probes=n_lists,
            registry=MetricsRegistry()), nq)
    if np.isin(sc2, kill).any():
        failures.append("stream fleet: the scatter returned a deleted id")
    alarms = [a.message() for m in monitors for a in m.alarms]
    if alarms:
        failures.append(f"stream fleet: drift alarms {alarms}")
    torch.cuda.synchronize()
    launches = dict(kbuild.LAUNCHES)
    log(f"  drift bands {[m.band for m in monitors]}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    log(f"  launches on the fleet path: {launches}")
    for name in ("binarize", "bq_dist_rows", "bq_pairwise", "list_scan"):
        if launches.get(name, 0) == 0:
            failures.append(f"{name} never launched on the fleet path")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


# the flash kernel each served step's calls must take
STEP_KERNEL = {"embed": "flash_attention_mma",
               "prefill": "flash_attention_mma",
               "decode": "flash_attention_split_kv"}


def counted(torch, tally: dict, launches, name: str, fn):
    """``fn`` with the launch counts reset before each call and read after
    it: a call's launches are added to ``tally[name]`` (a ``Counter``, with
    its ``calls`` and ``s``, the call's time on the host clock around
    synchronisation) and to ``launches``."""
    from repro_torch.kernels import build as kbuild

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        kbuild.reset_launches()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        rec = tally[name]
        rec["s"] += time.perf_counter() - t0
        rec["calls"] += 1
        rec.update(kbuild.LAUNCHES)
        launches.update(kbuild.LAUNCHES)
        return result
    return run


def check_step_flash(tally: dict, n_attn: int) -> None:
    """Each served step of ``tally`` (see :func:`counted`) launched
    ``flash_attention`` ``n_attn`` times a call, every launch through
    ``STEP_KERNEL[step]``; logs the counts."""
    for name, rec in tally.items():
        variant = STEP_KERNEL[name]
        counts = {key: rec[key] for key in ("flash_attention_mma",
                                            "flash_attention_split_kv",
                                            "flash_attention_fma")}
        log(f"  {name}: {rec['calls']} calls, {rec['flash_attention']} "
            f"flash_attention launches {counts}")
        if rec["calls"] == 0 \
                or rec["flash_attention"] != n_attn * rec["calls"]:
            raise AssertionError(f"flash_attention did not launch "
                                 f"{n_attn} times a call in {name}")
        if rec[variant] != rec["flash_attention"]:
            raise AssertionError(f"not every {name} call of flash_attention "
                                 f"took {variant}: {counts}")


def serve_lm(torch, kernels: dict, cfg, *, records: dict, n_docs: int = 0,
             n_held: int = 0) -> dict:
    """The serving path of ``cfg`` at full width and depth on the card:
    weights from seed 0 (bf16); 8 prompts of 64 tokens through
    ``ServeEngine.generate`` (``max_seq`` 384, 32 greedy tokens), twice.
    With ``n_docs``, RAG: ``n_docs`` + ``n_held`` seeded documents of 64
    tokens embedded with ``mean_pool_embedder`` (batches of 64), a
    ``QuIVerIndex`` (``BuildParams()``) over the first ``n_docs``,
    recall@10 at ef = 64 of the held-out ones (printed, not gated), and
    the prompts served through ``Retriever(k=4, ef=64)`` (prefill T =
    320).  A vlm (``frontend="patch_stub"``) is served behind its seeded
    patch embeddings (``extra_batch``; prefill T = 256 + 64).  Gates: the
    module's matrices are ``param_count()`` less
    ``transformer.param_count_gap`` (mamba's 1-D leaves); identical tokens
    in the two runs, in range; with RAG, every retrieved id in range,
    every context row its document's tokens and the bq kernels launched in
    the build; ``flash_attention`` launched once an attention layer a call
    of embed, prefill and decode, on the tensor-core kernel for embed and
    prefill and on the split-KV kernel for decode.  Each step's ms a call
    is printed with the flash kernel's share: its launches x the device
    time of ``kernels[records[step]]`` (phase 2's record at the step's
    shape; not measured without it).  Returns the launch counts and what
    the caller's own checks need."""
    import collections

    import numpy as np

    from repro_torch.core.baselines import flat_search, recall_at_k
    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_kinds, \
        matrix_param_count, param_count_gap
    from repro_torch.serve.engine import Retriever, ServeEngine, \
        mean_pool_embedder

    doc_len, batch = 64, 64
    n_prompts, prompt_len, max_new, max_seq, k = 8, 64, 32, 384, 4
    n_front = cfg.n_frontend_tokens if cfg.frontend == "patch_stub" else 0
    bundle = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = bundle.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = matrix_param_count(model)
    kinds = layer_kinds(cfg)
    n_attn = kinds.count("attn")
    experts = (f", {cfg.n_experts} routed experts of {cfg.d_ff} top-"
               f"{cfg.top_k} + {cfg.n_shared_experts} shared, router "
               "float32" if cfg.n_experts else "")
    mixers = ""
    if "mamba" in kinds:
        mixers = (f", {n_attn} attention and {cfg.n_layers - n_attn} mamba "
                  f"layers (d_inner {cfg.ssm_expand * cfg.d_model}, d_state "
                  f"{cfg.d_state})")
    if "mlstm" in kinds:
        mixers = (f", {kinds.count('mlstm')} mLSTM and "
                  f"{kinds.count('slstm')} sLSTM layers (d_inner "
                  f"{int(cfg.xlstm_expand * cfg.d_model)}, no attention)")
    front = f", {n_front} patch embeddings a prompt" if n_front else ""
    log(f"  {cfg.name}: {cfg.n_layers} layers{mixers}, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim_} over {cfg.n_kv_heads}, "
        f"d_ff {cfg.d_ff}{experts}, vocab {cfg.vocab_size} -> "
        f"{cfg.padded_vocab}{front}, bf16: {n_params} matrix parameters "
        f"(param_count() {cfg.param_count()}, param_count_gap "
        f"{param_count_gap(cfg)}; "
        f"{sum(p.numel() for p in model.parameters() if p.ndim == 1)} "
        f"elements of 1-D parameters in all), drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    if n_params + param_count_gap(cfg) != cfg.param_count():
        raise AssertionError("the module's parameters are not param_count()")

    launches: collections.Counter = collections.Counter()
    steps = STEP_KERNEL if n_docs else ("prefill", "decode")
    tally = {name: collections.Counter() for name in steps}
    rng = np.random.default_rng(0)
    served = {"launches": launches, "model": model, "bundle": bundle}
    retriever = None
    if n_docs:
        docs = rng.integers(0, cfg.vocab_size,
                            (n_docs + n_held, doc_len)).astype(np.int32)
        embed_fn = counted(torch, tally, launches, "embed",
                           mean_pool_embedder(bundle, model))
        emb = torch.cat([embed_fn(docs[i:i + batch])
                         for i in range(0, len(docs), batch)])
        embed_s = tally["embed"]["s"]
        log(f"  embed {len(docs)} documents x {doc_len} tokens in batches "
            f"of {batch}: {embed_s:.2f} s, {docs.size / embed_s:.0f} "
            "tokens/s")
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
        log(f"  QuIVerIndex.build over {n_docs} x {cfg.d_model}: "
            f"{build_s:.2f} s (linking {stats.seconds:.2f} s, {stats.chunks} "
            f"chunks, mean hops {stats.mean_hops:.1f}, {stats.consolidations} "
            f"consolidations); launches {build_counts}")
        for name in ("binarize", "bq_dist_rows", "bq_pairwise"):
            if build_counts.get(name, 0) == 0:
                raise AssertionError(f"{name} never launched in the build")

        truth, _ = flat_search(corpus, held, 10, device="cuda")
        kbuild.reset_launches()
        t0 = time.perf_counter()
        ids, scores = index.search(held, k=10, ef=64)
        search_s = time.perf_counter() - t0
        launches.update(kbuild.LAUNCHES)
        recall = recall_at_k(ids, truth)
        log(f"  recall@10 at ef=64 of {n_held} held-out documents: "
            f"{recall:.4f} ({n_held / search_s:.1f} QPS; printed, not gated)")
        if ids.shape != (n_held, 10) or not np.isfinite(scores).all() \
                or ids.min() < 0 or ids.max() >= n_docs:
            raise AssertionError("held-out search output malformed")
        served.update(docs=docs, corpus=corpus, index=index,
                      embed_fn=embed_fn)

    prompts = rng.integers(0, cfg.vocab_size,
                           (n_prompts, prompt_len)).astype(np.int32)
    extra = None
    if n_docs:
        retriever = Retriever(index=index, doc_tokens=docs[:n_docs],
                              embed_fn=embed_fn, k=k, ef=64)
        what = (f"{n_prompts} prompts x {prompt_len} tokens + {k} x "
                f"{doc_len} retrieved = prefill T = "
                f"{k * doc_len + prompt_len}")
    else:
        what = f"{n_prompts} prompts x {prompt_len} tokens"
    if n_front:
        extra = {"patches": torch.from_numpy(rng.standard_normal(
            (n_prompts, n_front, cfg.d_model)).astype(np.float32))
            .to("cuda", torch.bfloat16)}
        what = (f"{n_prompts} x ({n_front} patches + {prompt_len} tokens) "
                f"= prefill T = {n_front + prompt_len}")
    served.update(prompts=prompts, retriever=retriever, extra_batch=extra)
    engine = ServeEngine(bundle._replace(
        prefill=counted(torch, tally, launches, "prefill", bundle.prefill),
        decode=counted(torch, tally, launches, "decode", bundle.decode)),
        model, max_seq=max_seq, device="cuda")
    runs = []
    for attempt in range(2):
        before = {name: rec["s"] for name, rec in tally.items()}
        t0 = time.perf_counter()
        tokens = engine.generate(prompts, max_new=max_new,
                                 retriever=retriever, extra_batch=extra)
        wall = time.perf_counter() - t0
        runs.append(tokens)
        pre = tally["prefill"]["s"] - before["prefill"]
        dec = tally["decode"]["s"] - before["decode"]
        log(f"  generate {attempt + 1}: {what}: prefill {pre * 1e3:.1f} ms, "
            f"decode {dec / max_new * 1e3:.2f} ms a token, "
            f"{tokens.size / wall:.1f} new tokens/s ({wall:.2f} s in all)")
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("two generate runs gave different tokens")
    if runs[0].shape != (n_prompts, max_new) or runs[0].min() < 0 \
            or runs[0].max() >= cfg.vocab_size:
        raise AssertionError("generated tokens malformed")

    if n_docs:
        # the retrieval the prompts were served with
        hits, _ = index.search(embed_fn(prompts), k=k, ef=64)
        if hits.min() < 0 or hits.max() >= n_docs:
            raise AssertionError("a retrieved id is out of range")
        ctx = retriever.augment(prompts)[:, :k * doc_len] \
            .reshape(n_prompts, k, doc_len)
        if not np.array_equal(ctx, docs[hits]):
            raise AssertionError("a context row is not its document's "
                                 "tokens")
        log(f"  retrieval: {hits.size} ids in range, every context row its "
            f"document's tokens; first prompt's ids {hits[0].tolist()}")

    check_step_flash(tally, n_attn)
    # each step's flash kernel: its launches x its phase-2 device time at
    # the step's shape (decode at 352 keys, the longest step)
    for name, rec in tally.items() if n_attn else ():
        variant, record = STEP_KERNEL[name], records[name]
        call_ms = rec["s"] / rec["calls"] * 1e3
        if record in kernels:
            flash_ms = n_attn * kernels[record]["ms"]
            log(f"  {name}: {call_ms:.3f} ms a call, of which {variant} "
                f"{flash_ms:.3f} ms ({n_attn} launches x "
                f"{kernels[record]['ms']:.4f} ms device time, phase 2): "
                f"{flash_ms / call_ms:.1%}")
        else:
            log(f"  {name}: {call_ms:.3f} ms a call; the flash kernel's "
                "share not measured (phase 2 did not run)")
    return served


def phase_rag(torch, kernels: dict) -> dict:
    """LM serving with RAG, ``minicpm-2b`` at full width and depth
    (``serve_lm`` over 8 192 + 256 documents), then the probe, the
    retrieval through ``QueryEngine`` and a filtered retrieval; returns its
    launch counts."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.probe import probe_corpus, select_policy
    from repro_torch.serve.engine import QueryEngine, Retriever

    n_docs, doc_len, k = 8192, 64, 4
    served = serve_lm(torch, kernels, get_config("minicpm-2b"),
                      n_docs=n_docs, n_held=256,
                      records={"embed": "flash_attention_mma",
                               "prefill": "flash_attention_mma_prefill",
                               "decode": "flash_attention_split_kv"})
    launches, index, docs = served["launches"], served["index"], \
        served["docs"]
    prompts, retriever = served["prompts"], served["retriever"]
    embed_fn = served["embed_fn"]
    n_prompts = len(prompts)

    kbuild.reset_launches()
    t0 = time.perf_counter()
    report = probe_corpus(served["corpus"], device="cuda")
    probe_s = time.perf_counter() - t0
    launches.update(kbuild.LAUNCHES)
    log(f"  probe {probe_s:.3f} s: {report.summary()} (agreement "
        f"{report.bq_agreement:.4f}) -> {select_policy(report).describe()}")

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
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    del served, retriever, routed, index, embed_fn
    torch.cuda.empty_cache()
    return {"launches": dict(launches)}


def phase_moe(torch, kernels: dict) -> dict:
    """MoE serving with RAG, ``qwen2-moe-a2.7b`` at full width and depth
    (``serve_lm`` over 1 024 + 128 documents), then the dropped fraction of
    a scoring forward over the served prompts and ``launch.serve --smoke
    --rag`` on the card; returns its launch counts."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import transformer as tf

    cfg = get_config("qwen2-moe-a2.7b")
    served = serve_lm(
        torch, kernels, cfg, n_docs=1024, n_held=128,
        records={"embed": flash_record_key("flash_attention_mma",
                                           "qwen2 embed"),
                 "prefill": flash_record_key("flash_attention_mma",
                                             "qwen2 prefill"),
                 "decode": flash_record_key("flash_attention_split_kv",
                                            "qwen2 decode")})
    launches, model = served["launches"], served["model"]
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
        f"(bf16 weights {2 * cfg.param_count()} bytes)")

    # the capacity drops of serving: a scoring forward over the augmented
    # prompts (8 x 320 tokens, cap 32 a row and layer)
    augmented = served["retriever"].augment(served["prompts"])
    kbuild.reset_launches()
    with torch.no_grad():
        x = tf.embed_tokens(model, torch.from_numpy(augmented).cuda().long())
        _, aux = tf.forward_hidden(model, x)
    launches.update(kbuild.LAUNCHES)
    dropped = float(aux["dropped_fraction"]) / cfg.n_layers
    log(f"  scoring forward over the {augmented.shape[0]} x "
        f"{augmented.shape[1]} augmented prompts: dropped fraction "
        f"{dropped:.4f} a layer (mean over {cfg.n_layers}), load-balance "
        f"loss {float(aux['load_balance_loss']) / cfg.n_layers:.4f} a layer")
    del served, model, x
    torch.cuda.empty_cache()
    launch_smoke(["--arch", cfg.name, "--smoke", "--rag"])
    return {"launches": dict(launches)}


def launch_smoke(argv: list) -> None:
    """``launch.serve.main(argv)`` on the card; raises unless it returns 0."""
    from repro_torch.launch import serve as launch_serve

    t0 = time.perf_counter()
    rc = launch_serve.main(argv)
    if rc != 0:
        raise AssertionError(f"launch.serve {' '.join(argv)} returned {rc}")
    log(f"  launch.serve {' '.join(argv)} on the card: "
        f"{time.perf_counter() - t0:.1f} s")


# the hybrid phase's depth: two whole periods of jamba's 8-layer pattern
# (4 attention and 28 mamba layers at 32; 24 layers would take ~77 GB)
HYBRID_LAYERS = 16


def phase_hybrid(torch, kernels: dict) -> dict:
    """Hybrid serving with RAG, ``jamba-v0.1-52b`` at full width and
    ``HYBRID_LAYERS`` layers (``serve_lm`` over 1 024 + 128 documents:
    ``flash_attention`` once an attention layer a call, the mamba layers'
    states carried through decode), then ``launch.serve --smoke --rag`` on
    the card; returns its launch counts."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import param_count_gap

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=HYBRID_LAYERS)
    served = serve_lm(
        torch, kernels, cfg, n_docs=1024, n_held=128,
        records={step: flash_record_key(variant, f"jamba {step}")
                 for step, variant in (("embed", "flash_attention_mma"),
                                       ("prefill", "flash_attention_mma"),
                                       ("decode",
                                        "flash_attention_split_kv"))})
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
        f"(bf16 matrices {2 * (cfg.param_count() - param_count_gap(cfg))} "
        "bytes)")
    launches = served["launches"]
    del served
    gc.collect()
    torch.cuda.empty_cache()
    launch_smoke(["--arch", cfg.name, "--smoke", "--rag"])
    return {"launches": dict(launches)}


def phase_vlm(torch, kernels: dict) -> dict:
    """vlm serving, ``internvl2-2b`` at full width and depth (``serve_lm``
    without RAG: 8 prompts of 64 tokens behind 256 seeded patch embeddings
    each, 32 greedy tokens from position 320, twice; ``flash_attention``
    24 times a call), then a loss over (patches, tokens, labels), finite,
    its ``tokens`` metric B x (S - 256) = 512, and ``launch.serve
    --smoke`` on the card; returns the launch counts."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild

    cfg = get_config("internvl2-2b")
    served = serve_lm(
        torch, kernels, cfg,
        records={step: flash_record_key(variant, f"internvl2 {step}")
                 for step, variant in (("prefill", "flash_attention_mma"),
                                       ("decode",
                                        "flash_attention_split_kv"))})
    launches, bundle = served["launches"], served["bundle"]
    prompts = served["prompts"]
    n_prompts, prompt_len = prompts.shape
    labels = np.random.default_rng(1).integers(
        0, cfg.vocab_size, prompts.shape).astype(np.int32)
    kbuild.reset_launches()
    with torch.no_grad():
        loss, metrics = bundle.loss(served["model"], {
            "tokens": prompts, "labels": labels, **served["extra_batch"]})
    launches.update(kbuild.LAUNCHES)
    n_tok = float(metrics["tokens"])
    log(f"  loss over {n_prompts} x ({cfg.n_frontend_tokens} patches + "
        f"{prompt_len} tokens): {float(loss):.4f} over {n_tok:.0f} tokens")
    if n_tok != n_prompts * prompt_len or not np.isfinite(float(loss)):
        raise AssertionError(f"the loss counted {n_tok} tokens, not "
                             f"{n_prompts * prompt_len}, or is not finite")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
        f"(bf16 weights {2 * cfg.param_count()} bytes)")
    del served
    gc.collect()
    torch.cuda.empty_cache()
    launch_smoke(["--arch", cfg.name, "--smoke"])
    return {"launches": dict(launches)}


def phase_ssm(torch, kernels: dict) -> dict:
    """ssm serving with RAG, ``xlstm-1.3b`` at full width and depth
    (``serve_lm`` over 1 024 + 128 documents: 42 mLSTM and 6 sLSTM layers,
    every layer's float32 state carried through decode; no attention layer,
    so no flash launch), then ``launch.serve --smoke --rag`` on the card;
    returns its launch counts."""
    from repro_torch.configs.base import get_config

    cfg = get_config("xlstm-1.3b")
    served = serve_lm(torch, kernels, cfg, n_docs=1024, n_held=128,
                      records={})
    launches = served["launches"]
    if launches["flash_attention"]:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times on a "
                             "stack without attention")
    for name in ("binarize", "bq_dist_rows"):
        if not launches[name]:
            raise AssertionError(f"{name} never launched")
    log(f"  launches {dict(launches)}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes (bf16 weights "
        f"{2 * cfg.param_count()} bytes)")
    del served
    gc.collect()
    torch.cuda.empty_cache()
    launch_smoke(["--arch", cfg.name, "--smoke", "--rag"])
    return {"launches": dict(launches)}


@contextlib.contextmanager
def attention_calls():
    """The (causal, Tq) of every call of ``models.attention``'s
    ``flash_attention`` (self- and cross-attention alike) while the block
    runs, in call order."""
    from repro_torch.models import attention as attn_mod

    seen, inner = [], attn_mod.flash_attention

    def tap(q, k, v, *, causal=True, **kw):
        seen.append((causal, q.shape[1]))
        return inner(q, k, v, causal=causal, **kw)

    attn_mod.flash_attention = tap
    try:
        yield seen
    finally:
        attn_mod.flash_attention = inner


def phase_encdec(torch, kernels: dict) -> dict:
    """encdec serving, ``whisper-medium`` at full width and depth (24
    encoder and 24 decoder layers, d 1 024, 16 heads of 64, bf16 from seed
    0): 8 requests of 1 500 seeded frame embeddings (30 s of audio at 50
    frames a second) and 64-token prompts through
    ``ServeEngine.generate(extra_batch={"frames": ...})`` (``max_seq`` 96,
    32 greedy tokens from position 64), twice, identical; each prefill
    launches ``flash_attention`` 72 times on the tensor-core kernel (24
    encoder calls and 24 cross-attention calls without a causal mask, 24
    causal self-attention calls), each decode step 48 times on the split-KV
    kernel (24 causal self, 24 cross without a mask); then the loss over 8
    x 1 500 frames and 8 x 375 tokens: 72 tensor-core launches, 3 000
    tokens counted, finite.  Printed: the encoder's ms, prefill ms, decode
    ms a token, new tokens/s, peak memory; returns the launch counts."""
    import collections

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import encdec
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import matrix_param_count, \
        param_count_gap
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("whisper-medium")
    n_req, n_frames, prompt_len, max_new = 8, 1500, 64, 32
    n_enc, n_dec = cfg.n_layers, cfg.n_dec_layers
    bundle = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = bundle.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = matrix_param_count(model)
    log(f"  {cfg.name}: {n_enc} encoder + {n_dec} decoder layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim_}, d_ff "
        f"{cfg.d_ff} ({cfg.activation}), vocab {cfg.vocab_size} -> "
        f"{cfg.padded_vocab}, bf16: {n_params} matrix parameters "
        f"(param_count() {cfg.param_count()}, param_count_gap "
        f"{param_count_gap(cfg)}), drawn in {time.perf_counter() - t0:.1f} s")
    if n_params + param_count_gap(cfg) != cfg.param_count():
        raise AssertionError("the module's parameters are not param_count()")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (n_req, n_frames, cfg.d_model)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    prompts = rng.integers(0, cfg.vocab_size,
                           (n_req, prompt_len)).astype(np.int32)

    launches: collections.Counter = collections.Counter()
    with torch.no_grad():
        for attempt in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = encdec.encode(model, frames)
            torch.cuda.synchronize()
            enc_ms = (time.perf_counter() - t0) * 1e3
            log(f"  encode {n_req} x {n_frames} frames: {enc_ms:.1f} ms "
                f"({n_req * n_frames / enc_ms * 1e3:.0f} frames/s)"
                + (" (first call)" if attempt == 0 else ""))
    if not bool(torch.isfinite(enc).all()):
        raise AssertionError("the encoder's output is not finite")
    del enc
    enc_flash = (kernels.get(flash_record_key("flash_attention_mma",
                                              "whisper encoder")))
    if enc_flash:
        log(f"  of which flash_attention_mma {n_enc} x "
            f"{enc_flash['ms']:.4f} ms device time (phase 2) = "
            f"{n_enc * enc_flash['ms']:.2f} ms")

    tally = {name: collections.Counter() for name in ("prefill", "decode")}
    engine = ServeEngine(bundle._replace(
        prefill=counted(torch, tally, launches, "prefill", bundle.prefill),
        decode=counted(torch, tally, launches, "decode", bundle.decode)),
        model, max_seq=prompt_len + max_new, device="cuda")
    runs, calls = [], []
    for attempt in range(2):
        before = {name: rec["s"] for name, rec in tally.items()}
        t0 = time.perf_counter()
        with attention_calls() as seen:
            tokens = engine.generate(prompts, max_new=max_new,
                                     extra_batch={"frames": frames})
        wall = time.perf_counter() - t0
        runs.append(tokens)
        calls.append(seen)
        pre = tally["prefill"]["s"] - before["prefill"]
        dec = tally["decode"]["s"] - before["decode"]
        log(f"  generate {attempt + 1}: {n_req} x ({n_frames} frames, "
            f"{prompt_len} tokens): prefill {pre * 1e3:.1f} ms, decode "
            f"{dec / max_new * 1e3:.2f} ms a token, "
            f"{tokens.size / wall:.1f} new tokens/s ({wall:.2f} s in all)")
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("two generate runs gave different tokens")
    if runs[0].shape != (n_req, max_new) or runs[0].min() < 0 \
            or runs[0].max() >= cfg.vocab_size:
        raise AssertionError("generated tokens malformed")
    want_prefill = [(False, n_frames)] * n_enc \
        + [(True, prompt_len), (False, prompt_len)] * n_dec
    want_step = [(True, 1), (False, 1)] * n_dec
    for seen in calls:
        if seen != want_prefill + want_step * max_new:
            raise AssertionError("the attention calls of a generate run are "
                                 "not the encoder's, then self and cross "
                                 "a decoder layer")
    per_call = {"prefill": ("flash_attention_mma", 3 * n_dec),
                "decode": ("flash_attention_split_kv", 2 * n_dec)}
    for name, rec in tally.items():
        variant, n = per_call[name]
        log(f"  {name}: {rec['calls']} calls, {rec['flash_attention']} "
            f"flash_attention launches, {rec[variant]} of them {variant}")
        if rec["flash_attention"] != n * rec["calls"] \
                or rec[variant] != rec["flash_attention"]:
            raise AssertionError(f"{name} did not launch {variant} {n} "
                                 "times a call")
    cross = kernels.get(flash_record_key("flash_attention_split_kv",
                                         "whisper cross decode"))
    if cross:
        dec_ms = tally["decode"]["s"] / tally["decode"]["calls"] * 1e3
        log(f"  decode: {dec_ms:.3f} ms a step, of which the cross-attention"
            f"'s split-KV {n_dec} x {cross['ms']:.4f} ms device time "
            f"(phase 2): {n_dec * cross['ms'] / dec_ms:.1%}")

    labels = rng.integers(0, cfg.vocab_size,
                          (n_req, n_frames // 4)).astype(np.int32)
    dec_tokens = rng.integers(0, cfg.vocab_size,
                              (n_req, n_frames // 4)).astype(np.int32)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, metrics = bundle.loss(model, {
            "frames": frames, "tokens": dec_tokens, "labels": labels})
    loss = float(loss)
    loss_s = time.perf_counter() - t0
    counts = {key: kbuild.LAUNCHES[key] for key in (
        "flash_attention", "flash_attention_mma")}
    launches.update(kbuild.LAUNCHES)
    n_tok = float(metrics["tokens"])
    log(f"  loss over {n_req} x {n_frames} frames and {n_req} x "
        f"{n_frames // 4} tokens: {loss:.4f} over {n_tok:.0f} tokens in "
        f"{loss_s:.2f} s; launches {counts}")
    if n_tok != labels.size or not np.isfinite(loss) \
            or counts != {"flash_attention": 3 * n_dec,
                          "flash_attention_mma": 3 * n_dec}:
        raise AssertionError("the loss counted other tokens, is not finite "
                             "or launched other flash calls")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
        f"(bf16 matrices {2 * n_params} bytes)")
    del model, engine, frames
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": dict(launches)}


TRAIN_STEPS, TRAIN_MICRO, TRAIN_BATCH, TRAIN_SEQ = 10, 2, 8, 256


def train_setup() -> tuple:
    """(config, data config, train config) of the train phase: minicpm-2b at
    full width and depth, the synthetic ``TokenPipeline`` (T 256, global
    batch 8), two microbatches, WSD to peak 3e-4 after 2 warm-up steps."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = get_config("minicpm-2b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    tc = TrainConfig(n_micro=TRAIN_MICRO, peak_lr=3e-4, warmup=2,
                     total_steps=TRAIN_STEPS, schedule="wsd",
                     adamw=AdamWConfig())
    return cfg, data, tc


def phase_train(torch, kernels: dict) -> dict:
    """Training at full width and depth; returns the launch counts of the
    full-depth run (reset just before it, read just after).  ``kernels``
    holds phase 2's records, whose device time gives the backward kernel's
    share of a step (not measured without them)."""
    import dataclasses
    import math
    import shutil

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg, data, tc = train_setup()

    def trainer(arch, steps, **kw):
        return Trainer(build_model(arch), tc,
                       TrainerConfig(steps=steps, log_every=1, **kw),
                       TokenPipeline(data), seed=0, device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = trainer(cfg, TRAIN_STEPS, ckpt_dir=None)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    result = run.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log_ = result["metrics"]
    for m in log_:
        log(f"  step {m['step']}: loss {m['loss']:.4f}, grad norm "
            f"{m['grad_norm']:.4f}, {m['seconds']:.3f} s")
    losses = [m["loss"] for m in log_]
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            for m in log_):
        raise AssertionError("a loss or grad norm is not finite")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first - 0.2:
        raise AssertionError(f"loss did not fall by 0.2: {first} -> {last}")
    n_calls = cfg.n_layers * TRAIN_MICRO * TRAIN_STEPS
    for key in ("flash_attention_bwd", "flash_attention_bwd_mma"):
        if launches.get(key, 0) != n_calls:
            raise AssertionError(f"{key} launched {launches.get(key, 0)} "
                                 f"times, not {n_calls}")
    # each block's forward runs twice: once, and again in its backward
    if launches.get("flash_attention_mma", 0) != 2 * n_calls:
        raise AssertionError(f"flash_attention_mma launched "
                             f"{launches.get('flash_attention_mma', 0)} "
                             f"times, not {2 * n_calls} (remat)")
    opt = result["opt_state"]
    for n, mu in opt["mu"].items():
        if ".attn.w" in n and not bool((mu != 0).any()):
            raise AssertionError(f"{n} got no gradient in {TRAIN_STEPS} "
                                 "steps (its first moment is zero)")
    step_s = sum(m["seconds"] for m in log_[1:]) / (len(log_) - 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"  {cfg.name} at full width and depth ({cfg.n_layers} layers, "
        f"remat), global batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{TRAIN_MICRO} microbatches, {TRAIN_STEPS} steps in {t_run:.1f} s "
        f"(model and optimizer state drawn included): loss {first:.4f} -> "
        f"{last:.4f} (means of the first and last three); "
        f"{step_s:.3f} s a step after the first ({log_[0]['seconds']:.3f} "
        f"s), {tokens / step_s:.0f} tokens/s; max_memory_allocated {peak} "
        f"bytes; launches {launches}")
    rec = kernels.get("flash_attention_bwd_mma")
    per_step = cfg.n_layers * TRAIN_MICRO
    if rec:
        share = per_step * rec["ms"] / 1e3 / step_s
        log(f"  flash_attention_bwd_mma: {per_step} launches a step x "
            f"{rec['ms']:.4f} ms (phase 2's device time at this shape) = "
            f"{share:.1%} of a step")
    else:
        log("  flash_attention_bwd's share of a step: not measured (phase "
            "2 did not run)")
    del run, result, opt
    torch.cuda.empty_cache()

    # restart on the card: 2 steps, a checkpoint, resumed to 4 == 4 at once
    small = dataclasses.replace(cfg, n_layers=2)
    path = ROOT / "build" / "train_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    whole = trainer(small, 4, ckpt_dir=None).run()
    t0 = time.perf_counter()
    trainer(small, 2, ckpt_dir=str(path), ckpt_every=2).run()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = trainer(small, 4, ckpt_dir=str(path), ckpt_every=100).run()
    t_resume = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in (path / "step_2").iterdir())
    shutil.rmtree(path)
    if [m["step"] for m in resumed["metrics"]] != [2, 3] or [
            m["loss"] for m in resumed["metrics"]] != [
            m["loss"] for m in whole["metrics"][2:]]:
        raise AssertionError("the resumed run's losses differ")
    pairs = [(n, p, dict(whole["model"].named_parameters())[n])
             for n, p in resumed["model"].named_parameters()]
    for key in ("mu", "nu"):
        pairs += [(f"{key} {n}", t, whole["opt_state"][key][n])
                  for n, t in resumed["opt_state"][key].items()]
    pairs.append(("count", resumed["opt_state"]["count"],
                  whole["opt_state"]["count"]))
    for n, a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"resumed {n} differs from the "
                                 "uninterrupted run's")
    log(f"  restart, {small.name} x 2 layers: 2 steps + a checkpoint "
        f"({size} bytes) in {t_first:.1f} s, resumed to 4 in "
        f"{t_resume:.1f} s: parameters, moments and count identical to "
        "4 uninterrupted steps")
    del whole, resumed, pairs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out = launch_train.main(["--arch", "minicpm-2b", "--smoke", "--steps",
                             "8"])
    if out["final_step"] != 8:
        raise AssertionError("launch.train --smoke did not reach step 8")
    log(f"  launch.train --arch minicpm-2b --smoke --steps 8 on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    del out
    torch.cuda.empty_cache()
    return {"launches": launches}


# device-time groups of a training step: the matmuls and the flash kernels
# by lower-cased kernel name; every other kernel of the optimizer's or the
# accumulation's profiler range (train_step.SCOPES) is counted there, casts
# included; of the rest, copies, casts and fills by name, and the
# microbatches' other kernels (norms, rotary, SwiGLU, the loss) together
STEP_GROUPS = (
    ("flash backward", ("bwd_dq", "bwd_dkdv")),
    ("flash forward", ("flash_mma_kernel", "flash_split_kernel",
                       "flash_merge_kernel", "flash_kernel")),
    ("cuBLAS matmuls", ("gemm", "nvjet", "xmma", "cutlass", "splitk",
                        "cublas")),
)
COPIES = ("memcpy", "memset", "copy", "fill")
SCOPE_GROUPS = {"train_step::optimizer": "AdamW leaf updates and clip",
                "train_step::accumulate": "float32 gradient accumulation",
                "train_step::microbatch":
                    "norms, rotary, SwiGLU, loss: elementwise and reductions"}


def step_group(name: str, scope: str | None) -> str:
    low = name.lower()
    for group, keys in STEP_GROUPS:
        if any(key in low for key in keys):
            return group
    if scope != "train_step::microbatch" and scope in SCOPE_GROUPS:
        return SCOPE_GROUPS[scope]
    if any(key in low for key in COPIES):
        return "copies, casts and fills"
    return SCOPE_GROUPS.get(scope, "outside the step's ranges")


def step_breakdown(events, averages, wall: float, scopes) -> dict:
    """Where a profiled training step's time goes, from ``torch.profiler``'s
    ``events()`` and ``key_averages()`` and the step's host-clock ``wall``
    seconds: the device's busy share (the union of its kernels' and copies'
    intervals), the idle time between them (the device waiting for the
    host's launches), the 15 kernels with the most device time, and the
    device time by ``step_group``."""
    from torch.autograd import DeviceType

    def is_device(e):
        return (e.device_type == DeviceType.CUDA and e.name not in scopes
                and not getattr(e, "is_user_annotation", False))

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in events if is_device(e))
    busy, gaps = 0.0, []
    if spans:
        lo, hi = spans[0]
        for a, b in spans[1:]:
            if a > hi:
                busy += hi - lo
                gaps.append(a - hi)
                lo, hi = a, b
            else:
                hi = max(hi, b)
        busy += hi - lo
    windows = [(e.time_range.start, e.time_range.end, e.name)
               for e in events
               if e.name in scopes and e.device_type == DeviceType.CPU]

    def scope_at(t):
        inside = [name for a, b, name in windows if a <= t <= b]
        return inside[-1] if inside else None

    # the profiler hangs each kernel and copy on the op that launched it,
    # and on every other op of the same id: take each id once, in the range
    # its first op started in
    groups: dict = {}
    seen = set()
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels or e.id in seen:
            continue
        seen.add(e.id)
        scope = scope_at(e.time_range.start)
        for kinfo in e.kernels:
            if kinfo.name in scopes:
                continue
            group = step_group(kinfo.name, scope)
            ms, n = groups.get(group, (0.0, 0))
            groups[group] = (ms + kinfo.duration / 1e3, n + 1)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    top = sorted((e for e in averages if e.device_type == DeviceType.CUDA
                  and e.key not in scopes), key=dev_us, reverse=True)[:15]
    return {
        "wall_s": wall, "busy_s": busy / 1e6, "kernels": len(spans),
        "gaps_s": sum(gaps) / 1e6, "gaps": len(gaps),
        "gaps_over_20us_s": sum(g for g in gaps if g > 20) / 1e6,
        "gaps_over_20us": sum(1 for g in gaps if g > 20),
        "top": [(e.key, dev_us(e) / 1e3, e.count) for e in top],
        "groups": groups,
    }


def phase_trainprof(torch) -> None:
    """One steady step of the train phase's model and step (``train_setup``:
    minicpm-2b at full width and depth, remat, 8 x 256 tokens in two
    microbatches) under ``torch.profiler``, after an unprofiled warm-up
    step and an unprofiled steady step (their host-clock times printed):
    the device's busy share of the profiled step, the idle time between
    kernels, the 15 kernels with the most device time and the device time
    by group (``step_breakdown``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import SCOPES
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg, data, tc = train_setup()
    run = Trainer(build_model(cfg), tc, TrainerConfig(steps=3),
                  TokenPipeline(data), seed=0, device="cuda")
    model, opt, _ = run.init_or_restore()
    pipe = TokenPipeline(data)

    def step(i: int) -> float:
        nonlocal model, opt
        batch = pipe.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, _ = run.step_fn(model, opt, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm, steady = step(0), step(1)
    kbuild.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = step(2)
    launches = dict(kbuild.LAUNCHES)
    t0 = time.perf_counter()
    out = step_breakdown(prof.events(), prof.key_averages(), wall,
                         set(SCOPES))
    log(f"  {cfg.name} x {cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens in {TRAIN_MICRO} microbatches: warm-up step {warm:.3f} s, "
        f"steady step {steady:.3f} s unprofiled, {wall:.3f} s profiled "
        f"(post-processing {time.perf_counter() - t0:.1f} s); our kernels' "
        f"launches in it {launches}")
    if out["kernels"] == 0:
        raise AssertionError("the profile shows no device time: time the "
                             "step with CUDA events instead")
    log(f"  device busy {out['busy_s']:.4f} s of the profiled step's "
        f"{wall:.4f} s ({out['busy_s'] / wall:.1%}; of the unprofiled "
        f"step's {steady:.4f} s {out['busy_s'] / steady:.1%}) over "
        f"{out['kernels']} "
        f"kernels and copies; idle between them {out['gaps_s']:.4f} s in "
        f"{out['gaps']} gaps ({out['gaps_over_20us_s']:.4f} s in the "
        f"{out['gaps_over_20us']} over 20 us: the device waiting for the "
        f"host's launches); outside the first and last kernel "
        f"{wall - out['busy_s'] - out['gaps_s']:.4f} s")
    total = sum(ms for ms, _ in out["groups"].values())
    log(f"  device time by group ({total:.2f} ms attributed; ms, kernels "
        "and copies, share of the device's busy time):")
    for group, (ms, n) in sorted(out["groups"].items(),
                                 key=lambda kv: -kv[1][0]):
        log(f"    {ms:10.2f} ms {n:7d}  {ms / 1e3 / out['busy_s']:6.1%}  "
            f"{group}")
    log("  the 15 kernels with the most device time (ms, launches):")
    for key, ms, n in out["top"]:
        log(f"    {ms:10.2f} ms {n:7d}  {key[:100]}")
    del run, model, opt, prof
    torch.cuda.empty_cache()


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


def index_phases(torch, phases: list, timed) -> list:
    """Phases 4, 5, 6, filter, stream, engine and fleet, those of them in
    ``phases``, each under ``timed``; returns their results without their
    indexes and corpora (the launch counts and numbers)."""
    paths = []
    main_path = ivf_path = None
    if "main" in phases:
        with timed("main", "phase 4: main path, cohere-surrogate N=100000, "
                   "1000 queries"):
            main_path = phase_main(torch)
            paths.append(main_path)
    if "ivf" in phases:
        with timed("ivf", f"phase 5: IVF path, cohere-surrogate N={IVF_N} "
                   "(the first rows of phase 4's corpus), 1000 queries"):
            ivf_path = phase_ivf(torch)
            paths.append(ivf_path)
    if "ladder" in phases:
        with timed("ladder", "phase 6: metric ladder, cohere-surrogate "
                   "N=100000, 1000 queries; probe of three corpora"):
            paths.append(phase_ladder(torch, main_path))
    if "filter" in phases:
        with timed("filter", "phase filter: filtered search and query plans, "
                   "cohere-surrogate N=100000, 1000 queries, 8 labels"):
            paths.append(phase_filter(torch, main_path, ivf_path))
    if "stream" in phases:
        with timed("stream", "phase stream: the streaming index, "
                   f"cohere-surrogate N=100000, {STREAM_CYCLES} cycles of "
                   f"{STREAM_CHURN:.0%} churn"):
            paths.append(phase_stream(torch, main_path))
    if "engine" in phases:
        with timed("engine", "phase engine: the serving engine (QueryEngine) "
                   "and obs/, cohere-surrogate N=100000, 1000 queries, three "
                   "tenants"):
            paths.append(phase_engine(torch, main_path, ivf_path))
    if "fleet" in phases:
        with timed("fleet", f"phase fleet: the sharded fleet, {FLEET_SHARDS} "
                   f"shards over cohere-surrogate N={FLEET_N}; IVF scatter at "
                   "N=100000"):
            paths.append(phase_fleet(torch, main_path))
    # the index phases' indexes and corpora are not needed past here: the
    # LM phases start with nothing of them on the card
    for path in paths:
        for key in ("index", "data", "ids", "scores"):
            path.pop(key, None)
    return paths


def start_parity_child() -> tuple:
    """Phase 3 in a fresh interpreter (never a fork of a process that holds
    a CUDA context): ``chip_smoke.py --phases parity --parity-child``,
    which loads the kernels phase 1 built, caps its torch threads to leave
    the parent ``PARENT_CORES`` cores, and writes its log and its times
    under ``PARITY_DIR``.  Returns (the process, the epoch time it
    started)."""
    PARITY_DIR.mkdir(parents=True, exist_ok=True)
    (PARITY_DIR / "times.json").unlink(missing_ok=True)
    with open(PARITY_DIR / "log.txt", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phases",
             "parity", "--parity-child"],
            stdout=out, stderr=subprocess.STDOUT, cwd=ROOT)
    return proc, time.time()


def finish_parity_child(proc, started: float) -> float:
    """Wait for phase 3's child (at most ``PARITY_WAIT_S``), print its log
    whole, each line prefixed, and how much of its run the index phases
    hid; raise if it failed or had not ended (killed then).  Returns phase
    3's own seconds, as the child timed them."""
    waited = time.time()
    try:
        rc = proc.wait(timeout=PARITY_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = f"none: killed, not ended {PARITY_WAIT_S} s after the index phases"
    for line in (PARITY_DIR / "log.txt").read_text().splitlines():
        log(f"  [parity] {line}")
    if rc != 0:
        raise AssertionError(f"phase 3's child process failed: exit {rc}")
    times = json.loads((PARITY_DIR / "times.json").read_text())
    total = times["end"] - started
    hidden = min(times["end"], waited) - started
    log(f"  phase parity: {times['parity']} s in the child; the parent "
        f"waited {max(0.0, times['end'] - waited):.1f} s for it after the "
        "index phases")
    log(f"parity overlapped: {hidden:.1f} s of {total:.1f} s (the child's "
        "wall time, its interpreter start and CUDA set-up included)")
    return times["parity"]



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + OPT_IN))
    ap.add_argument("--parity-child", action="store_true",
                    help="run as phase 3's child process (see "
                    "start_parity_child)")
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
    if args.parity_child:
        cap = max(1, (os.cpu_count() or 1) - PARENT_CORES)
        torch.set_num_threads(cap)
        log(f"phase 3's child process: os.cpu_count() {os.cpu_count()}, "
            f"torch threads capped at {cap}")
    beside = "parity" in phases and any(p in phases for p in INDEX_PHASES)
    if beside:
        mode = nvidia_smi("compute_mode")
        log(f"compute mode: {mode}")
        if mode != "Default":
            log("  a second process cannot open a context on the card: "
                "phase 3 runs inline")
            beside = False

    from repro_torch.kernels import build as kbuild

    kernels = {}
    seconds: dict = {}
    t_all = time.perf_counter()

    @contextlib.contextmanager
    def timed(name: str, title: str):
        log(title)
        t0 = time.perf_counter()
        yield
        seconds[name] = round(time.perf_counter() - t0, 1)
        log(f"  phase {name}: {seconds[name]} s")

    if "build" in phases:
        with timed("build", "phase 1: build"):
            built = {k: round(v, 2) for k, v in kbuild.build().items()}
            log(f"  nvcc {json.dumps(built)} s (parallel)")
    if "kernels" in phases:
        with timed("kernels", "phase 2: kernels against their plain versions, "
                   "on the card"):
            kernels = phase_kernels(torch)
            phase_times(torch, kernels)
    child = None
    if beside:
        log(f"phase 3: the N={PARITY_N} builds and the LMs on the CPU and on "
            "the card, in a child process beside the index phases (its log "
            f"below once it ends: {PARITY_DIR.relative_to(ROOT)}/log.txt)")
        # phase 2's cached blocks (26.8 GB of hamming levels among them) go
        # back to the card, and the parent's allocator is held to a share
        # of it until the child ends
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(PARENT_MEMORY_SHARE)
        child = start_parity_child()
    elif "parity" in phases:
        with timed("parity", f"phase 3: the N={PARITY_N} builds and the "
                   "LMs on the CPU and on the card"):
            phase_parity(torch)
        if args.parity_child:
            (PARITY_DIR / "times.json").write_text(json.dumps(
                {"parity": seconds["parity"], "end": time.time()}))
    try:
        paths = index_phases(torch, phases, timed)
    except BaseException:
        if child is not None and child[0].poll() is None:
            child[0].kill()
            child[0].wait()
        raise
    if child is not None:
        seconds["parity"] = finish_parity_child(*child)
        torch.cuda.set_per_process_memory_fraction(1.0)
    gc.collect()
    torch.cuda.empty_cache()
    if "rag" in phases:
        with timed("rag", "phase 7: LM serving with RAG, minicpm-2b at full "
                   "width and depth"):
            paths.append(phase_rag(torch, kernels))
    if "moe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        with timed("moe", "phase moe: MoE serving with RAG, qwen2-moe-a2.7b "
                   "at full width and depth"):
            log(f"  memory_allocated at the start "
                f"{torch.cuda.memory_allocated()} bytes")
            paths.append(phase_moe(torch, kernels))
    if "hybrid" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        with timed("hybrid", "phase hybrid: hybrid serving with RAG, "
                   f"jamba-v0.1-52b at full width and {HYBRID_LAYERS} "
                   "layers"):
            log(f"  memory_allocated at the start "
                f"{torch.cuda.memory_allocated()} bytes")
            paths.append(phase_hybrid(torch, kernels))
    if "vlm" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        with timed("vlm", "phase vlm: vlm serving, internvl2-2b at full "
                   "width and depth with 256 patch embeddings a prompt"):
            paths.append(phase_vlm(torch, kernels))
    if "ssm" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        with timed("ssm", "phase ssm: ssm serving with RAG, xlstm-1.3b at "
                   "full width and depth"):
            paths.append(phase_ssm(torch, kernels))
    if "encdec" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        with timed("encdec", "phase encdec: encoder-decoder serving, "
                   "whisper-medium at full width and depth, 1 500 frames a "
                   "request"):
            paths.append(phase_encdec(torch, kernels))
    if "train" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        with timed("train", "phase train: training minicpm-2b at full width "
                   f"and depth, {TRAIN_STEPS} steps"):
            paths.append(phase_train(torch, kernels))
    if "trainprof" in phases:
        with timed("trainprof", "phase trainprof: profile of one training "
                   "step, minicpm-2b at full width and depth"):
            phase_trainprof(torch)
    if "profile" in phases:
        with timed("profile", "phase 8: profile of build chunks at "
                   "N=100000"):
            phase_profile(torch)
    log(f"all phases {time.perf_counter() - t_all:.1f} s: "
        f"{json.dumps(seconds)}")

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
