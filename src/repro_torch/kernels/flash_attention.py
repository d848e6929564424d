"""flash_attention: masked softmax attention with the online max/denominator
recurrence, for every attention call of the LM (embed, prefill, decode).

The CUDA kernel in ``csrc/flash_attention.cu`` replaces the Pallas TPU
kernel ``repro/kernels/flash_attention.py::_flash_kernel``.  It computes
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
the two round differently, within the tolerance).  The kernel reads the
model's ``(B, T, heads, hd)`` layout through its strides (the last axis
contiguous), so a KV cache slice needs no copy, and it indexes the KV head
as ``h // (H/K)``, so GQA needs no repeated K/V.

Each entry point follows ``q``'s device: a CPU tensor takes the plain
version (:func:`flash_attention_plain`, the naive masked softmax in
float32), a CUDA tensor launches the kernel or raises.
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
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quiver_flash_attention.argtypes = [
        p, p, p, p, i, i,             # q, k, v, out, q dtype, kv dtype
        i, i, i, i, i, i,             # b, tq, tk, h, kh, hd
        ll, ll, ll, ll, ll, ll, ll, ll, ll,   # q, k, v strides (b, t, h)
        i, i, i, ctypes.c_float, p,   # causal, q_offset, kv_valid_len,
    ]                                 # scale, stream
    lib.quiver_flash_attention.restype = i
    return lib


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
    status = _lib().quiver_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], _DTYPES[k.dtype], b, tq, tk, h, kh, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), q_offset, kv_valid_len, hd ** -0.5, stream,
    )
    build.LAUNCHES["flash_attention"] += 1
    build.check(status, "flash_attention")
    return out
