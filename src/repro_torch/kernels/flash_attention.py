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
                             or (causal and j > q_offset + i)
                             or (sliding_window and
                                 j <= q_offset + i - sliding_window))
                             . v[b, j, ...]

A sliding window (``sliding_window > 0``, the reference's mask at
``repro/models/attention.py:78-79, 125-126``) lets row i see only the keys
after ``q_offset + i - sliding_window``; every kernel, forward and backward,
starts its key loop at the first key its block can see, so the tiles wholly
outside the window are skipped rather than masked.  A row that sees no key
at all (possible only without a causal mask) is outside the kernels'
contract; the plain version gives it the reference's uniform average.

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

Gradients.  On the CPU autograd differentiates the plain version.  On the
card a call whose q, k or v needs a gradient (with grad mode on) goes
through :class:`FlashAttentionFn`: its forward is the kernel above (a bf16
call with Tq > 1 also writes each row's log-sum-exp, which it saves), its
backward :func:`flash_attention_backward`, which launches a dQ kernel and
a dK/dV kernel of ``csrc/flash_attention_bwd.cu``, chosen by dtype alone:

* bf16: the tensor-core kernels (``mma.sync`` bf16 products, P recomputed
  from the forward's log-sum-exp, P and dS rounded to bf16 before their
  products, as FlashAttention-2 and SDPA do);
  :func:`flash_attention_backward_mma_plain` mirrors their arithmetic in
  float32.  Without a saved log-sum-exp the wrapper gets it from the same
  forward kernel, so a direct call gives the autograd route's bits;
* float32: the CUDA-core kernels (float32 FMAs, their own log-sum-exp
  pass), whose arithmetic :func:`flash_attention_backward_plain` is.

Each call adds one to ``LAUNCHES["flash_attention_bwd"]`` and one to the
count of its route (:data:`BWD_VARIANTS`).  A checkpointed (remat) block
runs the forward kernel again in its backward, and counts it again.

Fake tensors.  A ``FakeTensorMode`` tensor has no memory to hand a kernel,
so a fake tensor, on whatever device (the dry run, ``launch/dryrun.py``),
takes the card's route through the custom ops ``repro_torch::flash_fwd``
and ``repro_torch::flash_bwd`` instead of a launch: their fake
implementations give the results' shapes, their real ones launch the same
kernels.  Nothing is launched or counted.  A real tensor never takes them:
the card's route and its launch counts are as above.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# head widths the kernel is instantiated for (MiniCPM's 64, the smoke
# configs' 16, the reference's kernel tests' 32 and 64, the MoE, hybrid and
# vlm models' 128, nemotron-4-340b's 192)
HEAD_DIMS = (16, 32, 64, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# keys a decode split (the kernels' kKeys)
SPLIT_KEYS = 64
LOG2E = 1.4426950408889634
# launch-count keys of the three kernels, by route
VARIANTS = {"mma": "flash_attention_mma",
            "split_kv": "flash_attention_split_kv",
            "fma": "flash_attention_fma"}
# launch-count key of the backward (its two kernels count as one call),
# and of its two routes
BWD = "flash_attention_bwd"
BWD_VARIANTS = {"mma": "flash_attention_bwd_mma",
                "fma": "flash_attention_bwd_fma"}


def flash_attention_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                          kv_valid_len: int | None = None,
                          sliding_window: int = 0) -> torch.Tensor:
    """The naive masked softmax in float32 (the form of
    ``repro/kernels/ref.py::flash_attention_ref`` plus the model's masks);
    returns ``q``'s dtype."""
    s = _scores(q, k, causal, q_offset, kv_valid_len, q.shape[3] ** -0.5,
                sliding_window)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, _grouped(q, k, v)[2]).to(
        q.dtype)


def flash_attention_backward_plain(q, k, v, out, dout, *,
                                   causal: bool = True, q_offset: int = 0,
                                   kv_valid_len: int | None = None,
                                   sliding_window: int = 0
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """dQ, dK, dV of :func:`flash_attention_plain` in float32, as the
    float32 backward kernel computes them: P recomputed from each row's
    log-sum-exp, ``D = rowsum(dO * O)`` from the forward's output ``out``,
    ``dS = P * (dP - D)``; dK and dV summed over each KV head's group.
    Returns q's, k's and v's dtypes."""
    scale = q.shape[3] ** -0.5
    s = _scores(q, k, causal, q_offset, kv_valid_len, scale, sliding_window)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    return _grads(q, k, v, out, dout, p, lambda x: x, scale)


def flash_attention_lse_plain(q, k, *, causal: bool = True,
                              q_offset: int = 0,
                              kv_valid_len: int | None = None,
                              sliding_window: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp as the tensor-core forward keeps it: in log2
    units of the score scaled by ``hd^-0.5 * log2 e`` (masked scores
    -1e30), ``m + log2(sum_j exp2(s_j - m))`` with ``m`` the row's max.
    Returns (B, H, Tq) float32."""
    s = _scores(q, k, causal, q_offset, kv_valid_len,
                q.shape[3] ** -0.5 * LOG2E, sliding_window)
    return _log2_sum_exp2(s)[..., 0]


def flash_attention_backward_mma_plain(q, k, v, out, dout, *,
                                       causal: bool = True,
                                       q_offset: int = 0,
                                       kv_valid_len: int | None = None,
                                       sliding_window: int = 0
                                       ) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """The bf16 backward kernel's arithmetic in float32: P = exp2(S * hd^-0.5
    * log2 e - lse), with the log-sum-exp of
    :func:`flash_attention_lse_plain`; ``D = rowsum(dO * O)`` from the
    forward's output, ``dS = P * (dP - D)`` in float32; then P and dS
    rounded to bf16 before dV = P^T dO, dQ = dS K and dK = dS^T Q (float32
    sums, dK and dV summed over each KV head's group), and the results
    rounded once to the inputs' dtypes."""
    scale = q.shape[3] ** -0.5
    s = _scores(q, k, causal, q_offset, kv_valid_len, scale * LOG2E,
                sliding_window)
    p = torch.exp2(s - _log2_sum_exp2(s))
    return _grads(q, k, v, out, dout, p, lambda x: x.bfloat16().float(),
                  scale)


def _grouped(q, k, v):
    """q, k, v in float32, k and v repeated to one KV head a query head."""
    g = q.shape[2] // k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    return qf, kf, vf


def _scores(q, k, causal: bool, q_offset: int, kv_valid_len: int | None,
            scale: float, sliding_window: int = 0) -> torch.Tensor:
    """(B, H, Tq, Tk) float32 scores q k^T * scale, -1e30 where masked."""
    tq, tk = q.shape[1], k.shape[1]
    kv_valid_len = tk if kv_valid_len is None else kv_valid_len
    qf, kf, _ = _grouped(q, k, k)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    k_pos = torch.arange(tk, device=q.device)
    q_pos = q_offset + torch.arange(tq, device=q.device)
    mask = (k_pos < kv_valid_len)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if sliding_window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - sliding_window)
    return s.masked_fill(~mask, NEG_INF)


def _log2_sum_exp2(s: torch.Tensor) -> torch.Tensor:
    m = s.amax(dim=-1, keepdim=True)
    return m + torch.log2(torch.exp2(s - m).sum(dim=-1, keepdim=True))


def _grads(q, k, v, out, dout, p, rounded, scale: float):
    """dQ, dK, dV from the probabilities ``p`` (B, H, Tq, Tk): ``dS = p *
    (dP - D)``, then ``rounded`` applied to P and dS before their products;
    dK and dV summed over each KV head's group, each cast to its input's
    dtype."""
    b, tq, h, hd = q.shape
    tk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf, kf, vf = _grouped(q, k, v)
    do = dout.float()
    d = (do * out.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = rounded(p * (dp - d))
    p = rounded(p)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    if g > 1:
        dk = dk.reshape(b, tk, kh, g, hd).sum(dim=3)
        dv = dv.reshape(b, tk, kh, g, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_decode_split_plain(q, k, v, *, causal: bool = True,
                             q_offset: int = 0,
                             kv_valid_len: int | None = None,
                             sliding_window: int = 0,
                             split_keys: int = SPLIT_KEYS) -> torch.Tensor:
    """The split-KV decode's arithmetic in float32, for Tq = 1: the keys
    ``[0, min(kv_valid_len, Tk))`` cut into splits of ``split_keys``, from
    the split that holds the window's first key (:func:`decode_splits`);
    each split's (m, l, o) over its visible keys, on scores scaled by
    ``hd^-0.5 * log2 e`` and exponentiated with exp2 (a split with no
    visible key has m = -1e30, l = 0, o = 0); then the merge, which rescales
    each split by exp2(m_s - m).  Returns ``q``'s dtype."""
    b, tq, h, hd = q.shape
    if tq != 1:
        raise ValueError(f"the split-KV decode takes Tq = 1, got {tq}")
    tk, kh = k.shape[1], k.shape[2]
    kv_end = min(tk if kv_valid_len is None else kv_valid_len, tk)
    last = min(kv_end, q_offset + 1) if causal else kv_end
    first = window_start(q_offset, sliding_window)
    g = h // kh
    scale = hd ** -0.5 * LOG2E
    qf = q[:, 0].float().reshape(b, kh, g, hd)
    ms, ls, os = [], [], []
    split0 = first // split_keys
    n_split = decode_splits(kv_end, q_offset, sliding_window, split_keys)
    for j0 in range(split0 * split_keys, (split0 + n_split) * split_keys,
                    split_keys):
        lo = max(first, j0)
        n_vis = max(0, min(j0 + split_keys, last) - lo)
        if n_vis == 0:
            ms.append(torch.full((b, kh, g), NEG_INF, device=q.device))
            ls.append(torch.zeros((b, kh, g), device=q.device))
            os.append(torch.zeros((b, kh, g, hd), device=q.device))
            continue
        s = torch.einsum("bkgd,bnkd->bkgn", qf,
                         k[:, lo:lo + n_vis].float()) * scale
        m = s.amax(dim=-1)
        p = torch.exp2(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os.append(torch.einsum("bkgn,bnkd->bkgd", p,
                               v[:, lo:lo + n_vis].float()))
    m = torch.stack(ms, dim=-1)                       # (b, kh, g, splits)
    w = torch.exp2(m - m.amax(dim=-1, keepdim=True))
    den = (torch.stack(ls, dim=-1) * w).sum(dim=-1)
    o = (torch.stack(os, dim=-2) * w[..., None]).sum(dim=-2)
    o = o / den.clamp_min(1e-30)[..., None]
    return o.reshape(b, 1, h, hd).to(q.dtype)


def window_start(q_offset: int, sliding_window: int) -> int:
    """The first key that query row 0 (at ``q_offset``) sees under a
    sliding window; 0 without one."""
    return max(0, q_offset - sliding_window + 1) if sliding_window else 0


def decode_splits(kv_end: int, q_offset: int, sliding_window: int = 0,
                  split_keys: int = SPLIT_KEYS) -> int:
    """The splits a decode launches: from the one holding the window's
    first key to the one holding key ``kv_end - 1`` (at least one)."""
    first = window_start(q_offset, sliding_window)
    return max(1, -(-kv_end // split_keys) - first // split_keys)


def _check(q, k, v, q_offset: int, kv_valid_len: int,
           sliding_window: int = 0) -> None:
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
    if sliding_window < 0:
        raise ValueError(f"sliding_window {sliding_window} is negative")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    strides = [ll] * 9                # q, k, v strides (b, t, h)
    lib.quiver_flash_attention.argtypes = [
        p, p, p, p, i,                # q, k, v, out, kv dtype
        i, i, i, i, i, i,             # b, tq, tk, h, kh, hd
        *strides, i, i, i, i, f, p,   # causal, q_offset, kv_valid_len,
    ]                                 # window, scale, stream
    lib.quiver_flash_attention_mma.argtypes = [
        p, p, p, p, p,                # q, k, v, out, lse (or null)
        i, i, i, i, i, i, *strides, i, i, i, i, f, p]
    lib.quiver_flash_decode_split.argtypes = [
        p, p, p, p, p, p, i,          # q, k, v, out, part_o, part_ml, splits
        i, i, i, i, i,                # b, tk, h, kh, hd
        ll, ll, *[ll] * 6,            # q (b, h), k and v (b, t, h) strides
        i, i, i, i, f, p]
    for fn in (lib.quiver_flash_attention, lib.quiver_flash_attention_mma,
               lib.quiver_flash_decode_split):
        fn.restype = i
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    tail = [i, i, i, i, i, i,         # b, tq, tk, h, kh, hd
            *[ll] * 9, i, i, i, i, f, p]  # strides, masking, scale, stream
    lib.quiver_flash_attention_bwd_mma.argtypes = [
        p, p, p, p, p, p,             # q, k, v, out, dout, the forward's lse
        p, p, p, p, *tail]            # dq, dk, dv, d scratch
    lib.quiver_flash_attention_bwd_fma.argtypes = [
        p, p, p, p, p,                # q, k, v, out, dout
        p, p, p, p, p, *tail]         # dq, dk, dv, lse and d scratch
    for fn in (lib.quiver_flash_attention_bwd_mma,
               lib.quiver_flash_attention_bwd_fma):
        fn.restype = i
    return lib


def _is_fake(t: torch.Tensor) -> bool:
    """A ``FakeTensorMode`` tensor (no storage: the custom ops' route)."""
    if type(t) is torch.Tensor:
        return False
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def _check_vectors(*named) -> None:
    """The bf16 kernels (and the backward in either dtype) copy rows in
    16-byte vectors: each base pointer, and each stride of a batch,
    position or head axis longer than 1, must keep rows on a 16-byte
    boundary (a fake tensor has no pointer and is not checked)."""
    for name, t in named:
        if _is_fake(t):
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data pointer is not 16-byte aligned, "
                             "which the kernels' 16-byte copies need")
        per = 16 // t.element_size()
        for dim in range(3):
            if t.shape[dim] > 1 and t.stride(dim) % per:
                raise ValueError(
                    f"{name}'s stride {t.stride(dim)} of axis {dim} is not a "
                    f"multiple of {per} elements (16 bytes), which the "
                    "kernels' 16-byte copies need")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_valid_len: int | None = None,
                    sliding_window: int = 0) -> torch.Tensor:
    """(B, Tq, H, hd) x (B, Tk, K, hd) x2 -> (B, Tq, H, hd) in ``q``'s
    dtype.  ``kv_valid_len`` defaults to Tk; ``q_offset`` is the position
    of query row 0 (the cache position in prefill and decode);
    ``sliding_window`` > 0 masks the keys at or before ``q_pos - window``.
    On the card, a call whose inputs need a gradient goes through
    :class:`FlashAttentionFn`."""
    kv_valid_len = k.shape[1] if kv_valid_len is None else int(kv_valid_len)
    q_offset, sliding_window = int(q_offset), int(sliding_window)
    _check(q, k, v, q_offset, kv_valid_len, sliding_window)
    if q.device.type == "cpu" and not _is_fake(q):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     kv_valid_len=kv_valid_len,
                                     sliding_window=sliding_window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _check_backward(q, k, v)
        return FlashAttentionFn.apply(q, k, v, causal, q_offset,
                                      kv_valid_len, sliding_window)
    return _forward(q, k, v, causal, q_offset, kv_valid_len, sliding_window)


def _forward(q, k, v, causal: bool, q_offset: int, kv_valid_len: int,
             sliding_window: int = 0,
             lse: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the forward kernel that ``q``'s dtype and Tq select.  With
    ``lse``, a (B, H, Tq) float32 tensor for bf16 q, the tensor-core kernel
    also writes each row's log-sum-exp into it, and is taken for any Tq."""
    b, tq, h, hd = q.shape
    tk, kh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    if _is_fake(q):
        return torch.ops.repro_torch.flash_fwd(
            q, k, v, bool(causal), q_offset, kv_valid_len, sliding_window)
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
    masking = (int(causal), q_offset, kv_valid_len, sliding_window,
               hd ** -0.5)
    if q.dtype == torch.float32:
        if lse is not None:
            raise ValueError("only the bf16 forward writes a log-sum-exp")
        variant = "fma"
        status = _lib().quiver_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[k.dtype], b, tq, tk, h, kh, hd, *strides, *masking, stream)
    else:
        _check_vectors(("q", q), ("k", k), ("v", v))
        if tq == 1 and lse is None:
            variant = "split_kv"
            n_split = decode_splits(kv_valid_len, q_offset, sliding_window)
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
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                0 if lse is None else lse.data_ptr(), b, tq, tk, h, kh, hd,
                *strides, *masking, stream)
    build.LAUNCHES["flash_attention"] += 1
    build.LAUNCHES[VARIANTS[variant]] += 1
    build.check(status, f"flash_attention ({variant})")
    return out


def _check_backward(q, k, v) -> None:
    """What the backward kernel takes: q, k and v of one dtype (float32 or
    bfloat16), a head width of :data:`HEAD_DIMS`, the head axis contiguous
    and rows on 16-byte boundaries."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the backward takes q, k, v of one dtype, float32 "
                         f"or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head width {q.shape[3]} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head axis must be contiguous")
    _check_vectors(("q", q), ("k", k), ("v", v))


def flash_attention_lse(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_valid_len: int | None = None,
                        sliding_window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention`'s output and each row's log-sum-exp ((B, H,
    Tq) float32, log2 units: :func:`flash_attention_lse_plain`), the
    saved state of the bf16 backward.  A CPU tensor takes the plain
    versions; bf16 on the card launches the tensor-core forward (for any
    Tq) with its log-sum-exp output; float32 on the card raises (its
    backward computes its own)."""
    kv_valid_len = k.shape[1] if kv_valid_len is None else int(kv_valid_len)
    q_offset, sliding_window = int(q_offset), int(sliding_window)
    _check(q, k, v, q_offset, kv_valid_len, sliding_window)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len,
              sliding_window=sliding_window)
    if q.device.type == "cpu" and not _is_fake(q):
        return (flash_attention_plain(q, k, v, **kw),
                flash_attention_lse_plain(q, k, **kw))
    b, tq, h, _ = q.shape
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, q_offset, kv_valid_len, sliding_window,
                    lse=lse), lse


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             q_offset: int = 0,
                             kv_valid_len: int | None = None,
                             sliding_window: int = 0,
                             lse: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """dQ, dK, dV of :func:`flash_attention` for the forward's output
    ``out`` and its incoming gradient ``dout`` (both (B, Tq, H, hd) in q's
    dtype).  A CPU tensor takes the plain version of the kernel its dtype
    selects (bf16: :func:`flash_attention_backward_mma_plain`, float32:
    :func:`flash_attention_backward_plain`).  A CUDA tensor launches the
    two kernels of ``csrc/flash_attention_bwd.cu`` for its dtype (bf16:
    tensor cores; float32: CUDA cores) or raises: on a dtype or head width
    they do not take, or on an ``out``/``dout`` that is not contiguous and
    16-byte aligned.  ``lse`` is the bf16 forward's log-sum-exp
    (:func:`flash_attention_lse`); without it the bf16 route gets it from
    the same forward kernel first."""
    kv_valid_len = k.shape[1] if kv_valid_len is None else int(kv_valid_len)
    q_offset, sliding_window = int(q_offset), int(sliding_window)
    _check(q, k, v, q_offset, kv_valid_len, sliding_window)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len,
              sliding_window=sliding_window)
    if q.device.type == "cpu" and not _is_fake(q):
        plain = (flash_attention_backward_mma_plain
                 if q.dtype == torch.bfloat16
                 else flash_attention_backward_plain)
        return plain(q, k, v, out, dout, **kw)
    _check_backward(q, k, v)
    if _is_fake(q):
        return tuple(torch.ops.repro_torch.flash_bwd(
            q, k, v, out, dout, bool(causal), q_offset, kv_valid_len,
            sliding_window))
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    b, tq, h, hd = q.shape
    tk, kh = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, tk, kh, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, kh, hd), dtype=v.dtype, device=v.device)
    dd = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = (q.stride(0), q.stride(1), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    tail = (b, tq, tk, h, kh, hd, *strides, int(causal), q_offset,
            kv_valid_len, sliding_window, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if q.dtype == torch.bfloat16:
        if lse is None:
            lse = flash_attention_lse(q, k, v, **kw)[1]
        elif (lse.shape != (b, h, tq) or lse.dtype != torch.float32
              or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError(f"lse must be ({b}, {h}, {tq}) float32, "
                             f"contiguous, on {q.device}")
        variant = "mma"
        status = _bwd_lib().quiver_flash_attention_bwd_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dd.data_ptr(), *tail)
    else:
        if lse is not None:
            raise ValueError("the float32 backward computes its own "
                             "log-sum-exp; lse is the bf16 route's")
        variant = "fma"
        scratch = torch.empty_like(dd)
        status = _bwd_lib().quiver_flash_attention_bwd_fma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), dd.data_ptr(), *tail)
    build.LAUNCHES[BWD] += 1
    build.LAUNCHES[BWD_VARIANTS[variant]] += 1
    build.check(status, f"flash_attention_bwd ({variant})")
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on a 16-byte boundary (a copy only where it is
    not): autograd may hand the backward a strided or offset gradient."""
    t = t.contiguous()
    return t if _is_fake(t) or t.data_ptr() % 16 == 0 else t.clone()


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` on the card with a gradient: the forward is
    the forward kernel, the backward the backward kernel; q, k, v, the
    output and (bf16, Tq > 1) the forward's log-sum-exp are saved for
    it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int,
                kv_valid_len: int, sliding_window: int = 0):
        lse = None
        if q.dtype == torch.bfloat16 and q.shape[1] > 1:
            lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                              dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal, q_offset, kv_valid_len,
                       sliding_window, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masking = (causal, q_offset, kv_valid_len, sliding_window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, kv_valid_len, sliding_window = ctx.masking
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, _aligned(dout), causal=causal, q_offset=q_offset,
            kv_valid_len=kv_valid_len, sliding_window=sliding_window, lse=lse)
        return dq, dk, dv, None, None, None, None


# The custom ops of the fake-tensor route (see the module docstring): their
# real implementations are the kernels' entry points above, their fake ones
# the results' shapes.


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, q_offset: int, kv_valid_len: int,
                  sliding_window: int) -> torch.Tensor:
    return _forward(q, k, v, causal, q_offset, kv_valid_len, sliding_window)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, q_offset, kv_valid_len, sliding_window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor, causal: bool,
                  q_offset: int, kv_valid_len: int, sliding_window: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_backward(
        q, k, v, out, dout, causal=causal, q_offset=q_offset,
        kv_valid_len=kv_valid_len, sliding_window=sliding_window)


@_flash_bwd_op.register_fake
def _(q, k, v, out, dout, causal, q_offset, kv_valid_len, sliding_window):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            torch.empty(k.shape, dtype=k.dtype, device=k.device),
            torch.empty(v.shape, dtype=v.dtype, device=v.device))
