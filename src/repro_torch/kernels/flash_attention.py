"""flash_attention: masked softmax attention with the online max/denominator
recurrence, for every attention call of the LM (embed, prefill, decode).

The CUDA kernels in ``csrc/flash_attention.cu`` replace the Pallas TPU
kernel ``repro/kernels/flash_attention.py::_flash_kernel``.  They compute
the model layer's function (``repro/models/attention.py::flash_attention``),
of which the Pallas kernel is the case ``q_offset = 0``,
``kv_valid_len = kv_len``::

    q (B, Tq, H, hd), k/v (B, Tk, K, hd); H % K == 0
    out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // (H/K)] * hd^-0.5,
                             masked where j >= kv_valid_len
                             or (causal and j > q_offset + i)) . v[b, j, ...]

Masked scores are -1e30 (not -inf), as in both references; sums are
float32 and the output has ``q``'s dtype.  The scale multiplies the
scores, as the model layer does (the Pallas kernel scales ``q`` first;
the two round differently, within the tolerance).  The kernels read the
model's ``(B, T, heads, hd)`` layout through its strides (the last axis
contiguous), so a KV cache slice needs no copy, and index the KV head
as ``h // (H/K)``, so GQA needs no repeated K/V.

The entry point follows ``q``'s device: a CPU tensor takes the plain
version (:func:`flash_attention_plain`, the naive masked softmax in
float32), a CUDA tensor launches one of the three kernels of
``csrc/flash_attention.cu`` or raises.  On the card the kernel is chosen by
dtype and by Tq, and nothing else:

* bf16 q, k and v, Tq > 1 (embed and prefill): the tensor-core kernel
  (``flash_mma_kernel``: ``mma.sync`` bf16 products, K/V tiles in a
  2-stage ``cp.async`` ring, P rounded to bf16 before P V, as
  FlashAttention-2 and SDPA do);
* bf16 q, k and v, Tq = 1 (decode): the split-KV kernel
  (``flash_split_kernel`` over splits of :data:`SPLIT_KEYS` keys, then
  ``flash_merge_kernel``), whose arithmetic
  :func:`flash_decode_split_plain` mirrors;
* float32 q over float32 or bf16 k/v: the CUDA-core kernel (``simt::
  flash_kernel``, float32 FMAs; TF32 tensor cores would keep about 3
  digits, outside the float32 tolerance of 2e-3).

bf16 q over float32 k/v raises.  The bf16 kernels copy rows in 16-byte
vectors, so they raise on a pointer, or a batch, position or head stride,
that does not keep every row on a 16-byte boundary.  Each call adds one
to ``build.LAUNCHES["flash_attention"]`` and one to the count of the
kernel it took (:data:`VARIANTS`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# head widths the kernel is instantiated for (MiniCPM's 64, the smoke
# configs' 16, the reference's kernel tests' 32 and 64)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# keys a decode split (the kernels' kKeys)
SPLIT_KEYS = 64
LOG2E = 1.4426950408889634
# launch-count keys of the three kernels, by route
VARIANTS = {"mma": "flash_attention_mma",
            "split_kv": "flash_attention_split_kv",
            "fma": "flash_attention_fma"}


def flash_attention_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                          kv_valid_len: int | None = None) -> torch.Tensor:
    """The naive masked softmax in float32 (the form of
    ``repro/kernels/ref.py::flash_attention_ref`` plus the model's masks);
    returns ``q``'s dtype."""
    b, tq, h, hd = q.shape
    tk, kh = k.shape[1], k.shape[2]
    kv_valid_len = tk if kv_valid_len is None else kv_valid_len
    g = h // kh
    kf, vf = k.float(), v.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (hd ** -0.5)
    k_pos = torch.arange(tk, device=q.device)
    q_pos = q_offset + torch.arange(tq, device=q.device)
    mask = (k_pos < kv_valid_len)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def flash_decode_split_plain(q, k, v, *, causal: bool = True,
                             q_offset: int = 0,
                             kv_valid_len: int | None = None,
                             split_keys: int = SPLIT_KEYS) -> torch.Tensor:
    """The split-KV decode's arithmetic in float32, for Tq = 1: the keys
    ``[0, min(kv_valid_len, Tk))`` cut into splits of ``split_keys``; each
    split's (m, l, o) over its visible keys, on scores scaled by
    ``hd^-0.5 * log2 e`` and exponentiated with exp2 (a split with no
    visible key has m = -1e30, l = 0, o = 0); then the merge, which rescales
    each split by exp2(m_s - m).  Returns ``q``'s dtype."""
    b, tq, h, hd = q.shape
    if tq != 1:
        raise ValueError(f"the split-KV decode takes Tq = 1, got {tq}")
    tk, kh = k.shape[1], k.shape[2]
    kv_end = min(tk if kv_valid_len is None else kv_valid_len, tk)
    last = min(kv_end, q_offset + 1) if causal else kv_end
    g = h // kh
    scale = hd ** -0.5 * LOG2E
    qf = q[:, 0].float().reshape(b, kh, g, hd)
    ms, ls, os = [], [], []
    for j0 in range(0, kv_end, split_keys):
        n_vis = max(0, min(split_keys, last - j0))
        if n_vis == 0:
            ms.append(torch.full((b, kh, g), NEG_INF, device=q.device))
            ls.append(torch.zeros((b, kh, g), device=q.device))
            os.append(torch.zeros((b, kh, g, hd), device=q.device))
            continue
        s = torch.einsum("bkgd,bnkd->bkgn", qf,
                         k[:, j0:j0 + n_vis].float()) * scale
        m = s.amax(dim=-1)
        p = torch.exp2(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os.append(torch.einsum("bkgn,bnkd->bkgd", p,
                               v[:, j0:j0 + n_vis].float()))
    m = torch.stack(ms, dim=-1)                       # (b, kh, g, splits)
    w = torch.exp2(m - m.amax(dim=-1, keepdim=True))
    den = (torch.stack(ls, dim=-1) * w).sum(dim=-1)
    o = (torch.stack(os, dim=-2) * w[..., None]).sum(dim=-2)
    o = o / den.clamp_min(1e-30)[..., None]
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _check(q, k, v, q_offset: int, kv_valid_len: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Tq, H, hd) and k, v (B, Tk, K, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head width, H % K == 0)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_attention route for {q.device}")
    if not 0 < kv_valid_len <= k.shape[1]:
        raise ValueError(f"kv_valid_len {kv_valid_len} outside "
                         f"(0, {k.shape[1]}]")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} is negative")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    strides = [ll] * 9                # q, k, v strides (b, t, h)
    lib.quiver_flash_attention.argtypes = [
        p, p, p, p, i,                # q, k, v, out, kv dtype
        i, i, i, i, i, i,             # b, tq, tk, h, kh, hd
        *strides, i, i, i, f, p,      # causal, q_offset, kv_valid_len,
    ]                                 # scale, stream
    lib.quiver_flash_attention_mma.argtypes = [
        p, p, p, p, i, i, i, i, i, i, *strides, i, i, i, f, p]
    lib.quiver_flash_decode_split.argtypes = [
        p, p, p, p, p, p, i,          # q, k, v, out, part_o, part_ml, splits
        i, i, i, i, i,                # b, tk, h, kh, hd
        ll, ll, *[ll] * 6,            # q (b, h), k and v (b, t, h) strides
        i, i, i, f, p]
    for fn in (lib.quiver_flash_attention, lib.quiver_flash_attention_mma,
               lib.quiver_flash_decode_split):
        fn.restype = i
    return lib


def _check_vectors(*named) -> None:
    """The bf16 kernels copy rows in 16-byte vectors (8 bf16): each base
    pointer, and each stride of a batch, position or head axis longer than
    1, must keep rows on a 16-byte boundary."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data pointer is not 16-byte aligned, "
                             "which the bf16 kernels' 16-byte copies need")
        for dim in range(3):
            if t.shape[dim] > 1 and t.stride(dim) % 8:
                raise ValueError(
                    f"{name}'s stride {t.stride(dim)} of axis {dim} is not a "
                    "multiple of 8 elements (16 bytes), which the bf16 "
                    "kernels' 16-byte copies need")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_valid_len: int | None = None) -> torch.Tensor:
    """(B, Tq, H, hd) x (B, Tk, K, hd) x2 -> (B, Tq, H, hd) in ``q``'s
    dtype.  ``kv_valid_len`` defaults to Tk; ``q_offset`` is the position
    of query row 0 (the cache position in prefill and decode)."""
    kv_valid_len = k.shape[1] if kv_valid_len is None else int(kv_valid_len)
    q_offset = int(q_offset)
    _check(q, k, v, q_offset, kv_valid_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     kv_valid_len=kv_valid_len)
    b, tq, h, hd = q.shape
    tk, kh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or k.dtype != v.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         "float32 or bfloat16, k and v alike")
    if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise ValueError("bfloat16 q with float32 k/v is not instantiated")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head axis must be contiguous")
    out = torch.empty((b, tq, h, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (q.stride(0), q.stride(1), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    masking = (int(causal), q_offset, kv_valid_len, hd ** -0.5)
    if q.dtype == torch.float32:
        variant = "fma"
        status = _lib().quiver_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[k.dtype], b, tq, tk, h, kh, hd, *strides, *masking, stream)
    else:
        _check_vectors(("q", q), ("k", k), ("v", v))
        if tq == 1:
            variant = "split_kv"
            n_split = -(-kv_valid_len // SPLIT_KEYS)
            part_o = torch.empty((b, h, n_split, hd), dtype=torch.float32,
                                 device=q.device)
            part_ml = torch.empty((b, h, n_split, 2), dtype=torch.float32,
                                  device=q.device)
            status = _lib().quiver_flash_decode_split(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                part_o.data_ptr(), part_ml.data_ptr(), n_split, b, tk, h, kh,
                hd, strides[0], strides[2], *strides[3:], *masking, stream)
        else:
            variant = "mma"
            status = _lib().quiver_flash_attention_mma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                tq, tk, h, kh, hd, *strides, *masking, stream)
    build.LAUNCHES["flash_attention"] += 1
    build.LAUNCHES[VARIANTS[variant]] += 1
    build.check(status, f"flash_attention ({variant})")
    return out
