"""Transformer-XL relative attention (single stream), forward with dropout
on the attention probabilities, and backward.

Replaces vilco_tpu/kernels/xl_attention.py::xl_rel_attention (the Pallas
`_run_fwd` and `_run_bwd` kernels) with csrc/xl_rel_attention.cu.

Forward: one block per (query tile, head, batch) with an online softmax in
f32; the relative shift, for which the TPU kernel rolled its (S, 2T)
position-score tile, is a load offset here: query row i reads r[T + j - i],
a band of BQ + BK - 1 rows of r per tile that the block stages in shared
memory. bfloat16 is FlashAttention-2 on mma.sync, as K1's forward, with
S, P and O in registers; each warp's position tile goes through its own
shared tile and comes back sheared, and K, V and the band stream through
cp.async rings. float32, the parity path, runs SIMT and is bound by FMA
issue. With a gradient to come it also stores the row log-sum-exp.

Dropout: the TPU kernel seeded its per-program PRNG, whose bits cannot be
matched. Here the keep bit of element (b, h, i, j) is word 0 of a
Philox4x32-10 block keyed by the step's 64-bit seed, with the element index
((b H + h) T + i) T + j as the counter: the mask depends on neither tile
size nor pass, so forward, backward and `philox_keep_mask` (plain torch
integer arithmetic) draw the same mask. keep iff bits >= rate 2^32; kept
probabilities scale by 1 / (1 - rate). A data-parallel rank holding rows
row0.. of the global batch adds row0 H T T to the counter (the seed
buffer's second word), so the ranks draw the global batch's mask.

Backward: five passes that write each output once and sum in a fixed
order, so two calls give equal bits (`xl_bwd_plain` is the same passes in
plain PyTorch): 1. delta = rowsum(dO O); 2. dk, dv by key tile over the
query tiles; 3. dq by query tile over the key tiles, and the column sums
of its two terms as partials of the bias gradients; 4. dr by tile of r's
positions over the batch and the query tiles; 5. the partials summed in
order. Each pass regenerates P from the saved log-sum-exp; in bf16 pass 2
draws the keep bits and stores them for passes 3 and 4. The inverse
relative shift, a log2 T cascade of rolls on the TPU (to dodge a Mosaic
miscompile), is an index: query row i and key j meet position T + j - i,
a band row that the passes read and write through shared memory.
bfloat16 runs every product on the tensor cores (mma.sync); float32 runs
SIMT.

A CPU tensor (any, in `plain_math()`) takes `xl_rel_attention_plain`
(autograd through it gives the backward); a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import torch

from vilco_tpu_torch.kernels import _build, takes_plain

NEG_INF = -1e9
LOG2E = 1.4426950408889634
MASKED = NEG_INF * LOG2E         # a masked key's score in the log2 domain
BWD_TILE = 64                    # query, key and position tile of K2-bwd
MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for 32-bit a and int64 b < 2^32,
    in 16-bit halves so that no int64 product overflows."""
    p1 = a * (b & 0xFFFF)
    t = (p1 >> 16) + a * (b >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p1 & 0xFFFF)


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: ctr a tuple of
    four tensors, key a pair of ints. Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & MASK32
        k1 = (k1 + PHILOX_W[1]) & MASK32
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def philox_keep_mask(seed: int, B: int, H: int, T: int, rate: float,
                     device=None, row0: int = 0) -> torch.Tensor:
    """(B, H, T, T) bool keep mask of the attention dropout of batch rows
    row0 .. row0 + B."""
    e = torch.arange(B * H * T * T, dtype=torch.int64, device=device) \
        + row0 * H * T * T
    zero = torch.zeros_like(e)
    bits = philox4x32_10((e & MASK32, e >> 32, zero, zero),
                         (seed & MASK32, (seed >> 32) & MASK32))[0]
    return (bits >= keep_threshold(rate)).reshape(B, H, T, T)


def xl_rel_attention_plain(q, k, v, r, r_w_bias, r_r_bias, mask,
                           seed: int = 0, rate: float = 0.0, row0: int = 0):
    """Plain version: XLRelAttention's attention core in f32 (f64 for f64
    inputs), returned in q.dtype. q/k/v (B, T, H, D), r (2T, H, D), biases
    (H, D), mask (B, T); the dropout mask of batch rows row0 ..."""
    dt = q.dtype
    ct = torch.promote_types(dt, torch.float32)
    q, k, v, r, rwb, rrb = (t.to(ct) for t in (q, k, v, r, r_w_bias,
                                                r_r_bias))
    B, T, H, D = q.shape
    scale = 1.0 / D ** 0.5
    ac = torch.einsum("bqhd,bkhd->bhqk", q + rwb, k)
    bd = torch.einsum("bqhd,khd->bhqk", q + rrb, r)        # (B, H, T, 2T)
    # relative shift, bd[..., i, j] = raw[..., i, T + j - i]
    bd = bd.reshape(B, H, 2 * T, T)[:, :, 1:]
    bd = bd.reshape(B, H, T, 2 * T - 1)[..., :T]
    att = ((ac + bd) * scale).masked_fill(~mask[:, None, None, :], NEG_INF)
    att = torch.softmax(att, dim=-1)
    if rate > 0.0:
        keep = philox_keep_mask(seed, B, H, T, rate, q.device, row0)
        att = torch.where(keep, att / (1.0 - rate), torch.zeros_like(att))
    vm = v * mask[:, :, None, None].to(ct)
    return torch.einsum("bhqk,bkhd->bqhd", att, vm).to(dt)


def _xl_scores(q, k, r, r_w_bias, r_r_bias, mask):
    """The log2-domain scores (B, H, T, T) as the kernels form them:
    ((q + r_w_bias) k_j + (q + r_r_bias) r[T + j - i]) * scale * log2 e,
    -1e9 * log2 e at masked keys; also (q + r_w_bias) and (q + r_r_bias)
    as (B, H, T, D). In f32 (f64 for f64 inputs)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    B, T, H, D = q.shape
    qh, kh = (x.to(ct).transpose(1, 2) for x in (q, k))
    qw = qh + r_w_bias.to(ct)[None, :, None, :]
    qr = qh + r_r_bias.to(ct)[None, :, None, :]
    raw = qr @ r.to(ct).permute(1, 2, 0)                   # (B, H, T, 2T)
    bd = raw.gather(-1, _shift_index(T, q.device).expand(B, H, T, T))
    s = (qw @ kh.transpose(-1, -2) + bd) * (LOG2E / D ** 0.5)
    return torch.where(mask[:, None, None, :], s, MASKED), qw, qr


def _shift_index(T: int, device=None) -> torch.Tensor:
    """(T, T) band row T + j - i of query i and key j."""
    i = torch.arange(T, device=device)
    return T + i[None, :] - i[:, None]


def xl_lse_plain(args) -> torch.Tensor:
    """The forward's row statistic (B, H, T) of args = (q, k, v, r,
    r_w_bias, r_r_bias, mask) in f32 (f64 for f64 inputs): lse = m +
    log2(l) of the log2-domain scores (`_xl_scores`)."""
    q, k, _, r, rwb, rrb, mask = args
    s = _xl_scores(q, k, r, rwb, rrb, mask)[0]
    m = s.amax(-1)
    return m + torch.log2(torch.exp2(s - m[..., None]).sum(-1))


def xl_bwd_plain(args, out, lse, dout, seed: int = 0, rate: float = 0.0,
                 row0: int = 0):
    """Plain version of K2-bwd, the kernels' five passes in f32 (f64 for
    f64 inputs) with their tiles and summation order, from the forward's
    out and lse (B, H, T):
      1. delta = rowsum(dO O);
      2. dk, dv over the query tiles of BWD_TILE rows, in order;
      3. dq over the key tiles in order, its content term (dS K) and
         position term (the sheared dS against r) apart, and each query
         tile's column sums of the two as the bias partials;
      4. dr by position tile, over the batch and then the query tiles;
      5. the bias partials summed over (batch, query tile) in order.
    P = exp2(s - lse), Pd = drop(P), dS = P (drop(dO v^T) - delta).
    Returns (dq, dk, dv, dr, d r_w_bias, d r_r_bias) in the inputs'
    dtype."""
    q, k, v, r, rwb, rrb, mask = args
    B, T, H, D = q.shape
    ct = torch.promote_types(q.dtype, torch.float32)
    tl = BWD_TILE
    s, qw, qr = _xl_scores(q, k, r, rwb, rrb, mask)
    kh, oh, gh = (x.to(ct).transpose(1, 2) for x in (k, out, dout))
    vh = (v.to(ct) * mask[:, :, None, None]).transpose(1, 2)
    rh = r.to(ct).transpose(0, 1)                          # (H, 2T, D)
    scale = 1.0 / D ** 0.5
    p = torch.exp2(s - lse.to(ct)[..., None])
    dp = gh @ vh.transpose(-1, -2)
    pd = p
    if rate > 0.0:
        keep = philox_keep_mask(seed, B, H, T, rate, q.device, row0)
        pd = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    delta = (gh * oh).sum(-1)                               # pass 1
    ds = p * (dp - delta[..., None])

    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)     # pass 2
    for i0 in range(0, T, tl):
        i1 = min(i0 + tl, T)
        dv = dv + pd[..., i0:i1, :].transpose(-1, -2) @ gh[:, :, i0:i1]
        dk = dk + ds[..., i0:i1, :].transpose(-1, -2) @ qw[:, :, i0:i1]
    dk = dk * scale
    dv = dv * mask[:, None, :, None]

    idx = _shift_index(T, q.device)                         # pass 3
    tw, tr = torch.zeros_like(qw), torch.zeros_like(qw)
    for j0 in range(0, T, tl):
        j1 = min(j0 + tl, T)
        tw = tw + ds[..., j0:j1] @ kh[:, :, j0:j1]
        tr = tr + torch.einsum("bhij,hijd->bhid", ds[..., j0:j1],
                               rh[:, idx[:, j0:j1]])
    dq = (tw + tr) * scale
    parts = [torch.stack([t[:, :, i0:i0 + tl].sum(2) * scale
                          for i0 in range(0, T, tl)], 1)    # (B, nq, H, D)
             for t in (tw, tr)]

    d_raw = torch.zeros(B, H, T, 2 * T, dtype=ct, device=q.device)
    d_raw.scatter_(-1, idx.expand(B, H, T, T), ds)          # pass 4
    dr = torch.zeros_like(rh)
    for p0 in range(0, 2 * T, tl):
        acc = torch.zeros_like(rh[:, p0:p0 + tl])
        for b in range(B):
            for i0 in range(0, T, tl):
                acc = acc + d_raw[b, :, i0:i0 + tl, p0:p0 + tl] \
                    .transpose(-1, -2) @ qr[b, :, i0:i0 + tl]
        dr[:, p0:p0 + tl] = acc * scale

    drwb, drrb = (torch.zeros_like(t[0, 0]) for t in parts)  # pass 5
    for b in range(B):
        for t in range(parts[0].shape[1]):
            drwb = drwb + parts[0][b, t]
            drrb = drrb + parts[1][b, t]
    back = lambda x, like: x.transpose(1, 2).to(like.dtype)
    return (back(dq, q), back(dk, k), back(dv, v),
            dr.transpose(0, 1).to(r.dtype), drwb.to(rwb.dtype), drrb.to(rrb.dtype))


def _seed_tensor(seed, device, base: int = 0) -> torch.Tensor:
    """The kernels' seed buffer on the card: two int64, the seed and the
    counter's base (`_seed_pair`). A seed tensor drawn there stays there
    (no host sync); an int is copied."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype != torch.int64 \
                or seed.device != device:
            raise ValueError("seed must be one int64 on the inputs' device")
        return _seed_pair(seed, base)
    return torch.tensor([_signed64(int(seed)), base], dtype=torch.int64,
                        device=device)


def _seed_pair(seed: torch.Tensor, base: int = 0) -> torch.Tensor:
    """[seed, base] as the kernels read them: a one-word seed gets the
    counter base `base` (0: the batch's first row is global row 0)."""
    if seed.numel() == 2:
        return seed.contiguous()
    return torch.cat([seed.reshape(1), seed.new_full((1,), base)])


def _signed64(u: int) -> int:
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= 1 << 63 else u


def _dropout_args(rate: float):
    """The keep threshold as a C int, and 1 / (1 - rate)."""
    thresh = keep_threshold(rate) if rate > 0.0 else 0
    return _build.as_c_int(thresh), 1.0 / (1.0 - rate)


def xl_fwd_cuda(args, seed: torch.Tensor, rate: float, with_lse: bool):
    """Launch the forward kernel: (out, lse (B, H, T) f32 or None)."""
    q = args[0]
    B, T, H, D = q.shape
    seed = _seed_pair(seed)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    thresh, inv_keep = _dropout_args(rate)
    fn = _build.bind("xl_rel_attention", "xl_rel_attention_fwd", 10, 6, 1)
    err = fn(*(t.data_ptr() for t in args), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), seed.data_ptr(), B, T, H,
             D, _build.dtype_code(q), thresh, inv_keep, _build.stream_of(q))
    _build.check(err, "xl_rel_attention_fwd")
    xl_rel_attention.launches += 1
    return out, lse


def xl_bwd_cuda(args, out, lse, dout, seed: torch.Tensor, rate: float):
    """Launch the backward's five kernels: (dq, dk, dv, dr, d r_w_bias,
    d r_r_bias), each in its input's dtype and written once."""
    q, k, v, r, rwb, rrb, mask = args
    B, T, H, D = q.shape
    seed = _seed_pair(seed)
    dev, f32 = q.device, torch.float32
    dout = dout.contiguous()
    grads = [torch.empty_like(t) for t in args[:6]]
    delta = torch.empty((B, H, T), dtype=f32, device=dev)
    # the bias partials of the dq pass's query tiles (32 rows at the least)
    partial = torch.empty((2, B * -(-T // 32), H, D), dtype=f32, device=dev)
    thresh, inv_keep = _dropout_args(rate)
    # bf16: the keep bits, drawn once by the dk/dv pass for the dq and dr
    # passes, 64 keys a word
    bits = (torch.empty((B, H, T, -(-T // 64)), dtype=torch.int64,
                        device=dev)
            if thresh and q.dtype == torch.bfloat16 else None)
    fn = _build.bind("xl_rel_attention", "xl_rel_attention_bwd", 20, 6, 1)
    err = fn(*(t.data_ptr() for t in args), out.data_ptr(), lse.data_ptr(),
             dout.data_ptr(), *(t.data_ptr() for t in grads),
             delta.data_ptr(), partial.data_ptr(),
             0 if bits is None else bits.data_ptr(), seed.data_ptr(), B, T,
             H, D, _build.dtype_code(q), thresh, inv_keep,
             _build.stream_of(q))
    _build.check(err, "xl_rel_attention_bwd")
    xl_bwd_cuda.launches += 1
    return tuple(grads)


xl_bwd_cuda.launches = 0


class _XLRelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, r, rwb, rrb, mask, seed, rate):
        args = (q, k, v, r, rwb, rrb, mask)
        out, lse = xl_fwd_cuda(args, seed, rate, with_lse=True)
        ctx.save_for_backward(*args, out, lse, seed)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dout):
        *args, out, lse, seed = ctx.saved_tensors
        grads = xl_bwd_cuda(tuple(args), out, lse, dout, seed, ctx.rate)
        return (*grads, None, None, None)


def xl_rel_attention(q, k, v, r, r_w_bias, r_r_bias, mask, seed=0,
                     rate: float = 0.0, row0: int = 0):
    """Returns (B, T, H, D); invalid query rows are not zeroed. `seed`, a
    64-bit int or one int64 tensor on the inputs' device, keys the dropout
    mask when rate > 0; `row0`, the global row of the batch's first (a
    data-parallel rank's rows), offsets its element counter.
    Differentiable in q, k, v, r and both biases."""
    B, T, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or r.shape != (2 * T, H, D) \
            or r_w_bias.shape != (H, D) or r_r_bias.shape != (H, D) \
            or mask.shape != (B, T):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, r {tuple(r.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    args = (q, k, v, r, r_w_bias, r_r_bias, mask)
    if takes_plain(q):
        return xl_rel_attention_plain(*args, seed=int(seed), rate=rate,
                                      row0=row0)
    if q.device.type != "cuda" or any(t.device != q.device for t in args):
        raise ValueError("all inputs must be on one CUDA device")
    _build.dtype_code(q)
    if any(t.dtype != q.dtype for t in args[:6]) or mask.dtype != torch.bool:
        raise TypeError("q, k, v, r and biases must share a dtype, mask bool")
    if D > 128:
        raise ValueError(f"head dim {D} > 128")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("all inputs must be contiguous")
    seed = _seed_tensor(seed, q.device, row0 * H * T * T)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:6]):
        return _XLRelAttention.apply(*args, seed, rate)
    return xl_fwd_cuda(args, seed, rate, with_lse=False)[0]


xl_rel_attention.launches = 0
