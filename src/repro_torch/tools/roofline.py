"""Roofline terms of a dry-run cell, from the port's own counts.

Counterpart of ``repro/tools/roofline.py``.  Three terms per (arch x shape
x mesh), in seconds a step:

    compute    = flops a device / peak FLOP/s
    memory     = bytes a device / HBM bytes/s
    collective = collective bytes a device / network bytes/s

The counts are ``tools/op_cost.py``'s (one device's ops, the flash kernels
at the pairs they visit) and ``tools/collectives.py``'s (the result bytes
of every collective one rank runs), both taken while the dry run
(``launch/dryrun.py``) runs a step as rank 0 of a fake process group; the
reference reads XLA's cost analysis and its optimized HLO instead.  The
byte count is the same pre-fusion upper bound as the reference's (the
port runs eagerly, so it also is what the port moves).

Hardware model: NVIDIA H100 SXM (its datasheet): 989 TFLOP/s dense bf16
on the tensor cores, 3.35 TB/s HBM3.  A 16x16 mesh spans 32 nodes of 8
cards, so a collective over it crosses the network: 400 Gb/s a card (one
ConnectX-7 port each), 50 GB/s, is the link rate of the collective term;
NVLink's 900 GB/s a card inside a node is reported beside it
(``nvlink_bw``) and not used.
"""

from __future__ import annotations

H100 = {
    "peak_flops": 989e12,     # bf16 dense, tensor cores, a card
    "hbm_bw": 3.35e12,        # bytes/s a card
    "link_bw": 50e9,          # bytes/s a card: 400 Gb/s network
    "nvlink_bw": 900e9,       # bytes/s a card inside a node (not used)
    "source": "NVIDIA H100 SXM datasheet",
}


def analyze(costs: dict, collectives: dict, *, n_chips: int,
            model_flops: float, memory_analysis: dict | None = None,
            hw: dict | None = None) -> dict:
    """The roofline report of one cell: ``costs`` one device's
    ``{"flops", "bytes", "by_prim"}`` (``tools.op_cost``), ``collectives``
    one device's (``tools.collectives``).  Keeps the reference's keys
    (``terms_seconds``, ``dominant``, ``bound_seconds``,
    ``useful_flops_ratio``, ``mfu_at_bound``, ``collectives``,
    ``memory_analysis``)."""
    hw = hw or H100
    flops_dev = float(costs["flops"])
    bytes_dev = float(costs["bytes"])
    compute_s = flops_dev / hw["peak_flops"]
    memory_s = bytes_dev / hw["hbm_bw"]
    collective_s = collectives["total_bytes"] / hw["link_bw"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    total_flops = flops_dev * n_chips
    return {
        "n_chips": n_chips,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collectives": collectives,
        "terms_seconds": terms,
        "dominant": dominant,
        "bound_seconds": bound_s,
        "model_flops": model_flops,
        "useful_flops_ratio": (
            model_flops / total_flops if total_flops else 0.0),
        "mfu_at_bound": (
            model_flops / (n_chips * hw["peak_flops"] * bound_s)
            if bound_s else 0.0),
        "memory_analysis": memory_analysis,
        "hardware": {k: hw[k] for k in ("peak_flops", "hbm_bw", "link_bw",
                                        "nvlink_bw", "source")},
    }


def model_flops_for(cfg, shape) -> float:
    """6·N_active·tokens for training, 2·N_active·tokens for inference."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one new token per sequence
    return 2.0 * n * shape.global_batch
