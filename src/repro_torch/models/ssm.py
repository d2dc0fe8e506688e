"""State-space and recurrent blocks (port of ``repro.models.ssm``): Mamba
(Hymba's SSM heads) and the xLSTM cells, mLSTM and sLSTM.

The reference's scans are XLA code (``lax.scan`` over chunks, with
``lax.associative_scan`` inside a chunk); these are PyTorch code, with the
reference's names and its chunking:

* :func:`chunked_linear_scan` and :func:`chunked_ssm_outputs` run a Python
  loop over the chunks of the sequence and, inside a chunk, a blocked scan
  of ``h_t = a_t h_{t-1} + b_t`` (:func:`_scan_`, differentiable under
  autograd): every block of
  :data:`BLOCK` positions scans from zero, all blocks at once, one
  position a step; the carries then cross the blocks one by one, and one
  pass adds each block's carry to its positions.  That is a few passes
  over the chunk tensor, where a doubling scan makes a few a level over
  ``log2(chunk)`` levels (PERF.md) and a per-step loop makes
  ``chunk`` launches of a few ops each.  The live tensor is the
  chunk's (B, chunk, d_inner, N), never the whole sequence's.  Element
  ``p``'s arithmetic depends only on ``p`` (its block is ``p // BLOCK``
  whatever the length), so a longer (right-padded) chunk cannot
  re-associate a prefix, which the reference's ``associative_scan`` also
  gives.
* :func:`mlstm_chunkwise` is the reference's chunkwise-parallel stabilized
  mLSTM; its running max (an ``associative_scan`` of ``maximum`` there) is
  ``torch.cummax``.
* The sLSTM's recurrence is sequential, one step per position, as in the
  reference; its four recurrent products are one batched product a step
  (over the stacked ``rz, ri, rf, ro``), with the state kept head-major
  inside the loop.

The products outside a ``Linear`` (the mLSTM's seven products, the
sLSTM's recurrent one, Mamba's readout) are each one
:func:`~repro_torch.kernels.gemm.bgemm` over the batch (and heads): on
the card a row's sums then run in an order fixed by its (K, N), not by
the batch, so a request's output does not depend on the rows beside it
(``docs/serving.md``; under cuBLAS, xlstm-350m's x0 moved across batch
buckets).  ``meta`` tensors keep the einsums and ``baddbmm``, which the
dry run counts.

Every scan's padding is an identity step, as in the reference (``a`` = 1,
``dt`` = 0, ``i_pre`` = -1e30 with ``logf`` = 0), so the last state of a
padded sequence is its true last state.  The scans read nothing from the
host: step counts come from shapes only, so a captured CUDA graph can hold
them.  ``A_log``, ``D`` and the sLSTM's recurrent weights are stored in
float32, as the reference computes with them; every other weight is
stored in the compute dtype (``layers.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.gemm import bgemm
from repro_torch.models import layers as L

Tensor = torch.Tensor
NEG = -1e30


def _pad_time(t: Tensor, pad: int, value: float = 0.0) -> Tensor:
    """Right-pad axis 1 of ``t`` by ``pad`` entries of ``value``."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad), value=value)


#: positions of one block of :func:`_scan_inplace`
BLOCK = 16


def _scan_inplace(a: Tensor, b: Tensor) -> Tensor:
    """Inclusive scan of ``h_p = a_p h_{p-1} + b_p`` over axis 1 (with
    ``h_{-1} = 0``), in place over ``a`` and ``b`` (contiguous); returns
    every ``h_p``.  ``a`` may broadcast against ``b`` on its trailing dims.

    Blocks of ``t = min(BLOCK, n)`` positions (the last one padded with
    identity steps): (1) each block scans from zero, all blocks at once,
    while ``a`` becomes the running product of its gates from the block's
    start; (2) the true value at each block's last position, block by
    block; (3) each block's carry-in times the running products, added to
    its other positions."""
    n = b.shape[1]
    t = min(BLOCK, n)
    nb = -(-n // t)
    if nb * t > n:
        a, b = _pad_time(a, nb * t - n, 1.0), _pad_time(b, nb * t - n)
    ab = a.view(a.shape[0], nb, t, *a.shape[2:])
    bb = b.view(b.shape[0], nb, t, *b.shape[2:])
    for i in range(1, t):
        bb[:, :, i].addcmul_(ab[:, :, i], bb[:, :, i - 1])
        if nb > 1:
            ab[:, :, i].mul_(ab[:, :, i - 1])
    for k in range(1, nb):
        bb[:, k, t - 1].addcmul_(ab[:, k, t - 1], bb[:, k - 1, t - 1])
    if nb > 1 and t > 1:
        carry = bb[:, :-1, t - 1 :].clone()
        bb[:, 1:, : t - 1].addcmul_(ab[:, 1:, : t - 1], carry)
    return b[:, :n]


class _LinearScan(torch.autograd.Function):
    """:func:`_scan_inplace` under autograd.  The forward runs it on copies
    of ``a`` and ``b`` (the same arithmetic, so bitwise the same ``h``).
    The adjoint of ``h_p = a_p h_{p-1} + b_p`` is the same recurrence run
    backward, ``g_p = dh_p + a_{p+1} g_{p+1}``, which the forward scan
    computes on the flipped sequence; then ``db_p = g_p`` and ``da_p = g_p
    h_{p-1}`` (summed over the dims ``a`` broadcasts on)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _scan_inplace(a.clone(), b.clone())
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        n = h.shape[1]
        # the flipped gates: a_{p+1} at flipped position n-1-p (position 0
        # of the flipped scan starts from zero, its gate is never read)
        gate = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
        g = _scan_inplace(torch.flip(gate, [1]).contiguous(),
                          torch.flip(dh, [1]).contiguous())
        g = torch.flip(g, [1])
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, : n - 1]], dim=1)
        da = g * h_prev
        dims = [i for i in range(2, a.dim()) if a.shape[i] == 1 and da.shape[i] != 1]
        if dims:
            da = da.sum(dim=dims, keepdim=True)
        return da, g


def _scan_(a: Tensor, b: Tensor) -> Tensor:
    """Inclusive scan of ``h_p = a_p h_{p-1} + b_p`` over axis 1 (``h_{-1} =
    0``); ``a`` may broadcast against ``b`` on its trailing dims.  Without
    autograd it runs in place over ``a`` and ``b`` (contiguous, both
    clobbered); under autograd (grad enabled and ``a`` or ``b`` requiring
    grad) it is differentiable through :class:`_LinearScan`, with the same
    result bitwise."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _LinearScan.apply(a, b)
    return _scan_inplace(a, b)


def _chunking(s: int, chunk: int) -> tuple[int, int, int]:
    """(chunk, number of chunks, padding) of a length-``s`` scan."""
    chunk = max(min(chunk, s), 1)
    nchunks = -(-s // chunk)
    return chunk, nchunks, nchunks * chunk - s


def stacked(state: dict, count: int) -> dict:
    """``state`` repeated over a leading layer axis of ``count``: a segment's
    cache."""
    return {k: v[None].repeat((count,) + (1,) * v.ndim) for k, v in state.items()}


def layer_state(cache: dict | None, layer: int) -> dict | None:
    """Layer ``layer`` of a segment's cache (views), or None without one."""
    return None if cache is None else {k: v[layer] for k, v in cache.items()}


def store_layer_state(cache: dict | None, layer: int, new: dict) -> None:
    """Write a layer's new state ``new`` into layer ``layer`` of ``cache``."""
    if cache is not None:
        for k, v in new.items():
            cache[k][layer].copy_(v)


# ---------------------------------------------------------------------------
# Linear recurrence:  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------


def chunked_linear_scan(a: Tensor, b: Tensor, h0: Tensor, chunk: int):
    """Scan h_t = a_t h_{t-1} + b_t over axis 1 (time).

    a: (B, S, ...) gate (trailing dims may be 1); b: (B, S, ...); h0: (B,
    ...) matching b's trailing dims.  Returns (h_all (B, S, ...), h_last).
    No block calls it (Mamba runs the fused :func:`chunked_ssm_outputs`);
    it keeps the reference's public scan, held to it in the tests.
    """
    s = b.shape[1]
    chunk, nchunks, pad = _chunking(s, chunk)
    if pad:
        a = _pad_time(a, pad, 1.0)
        b = _pad_time(b, pad)
    h, hs = h0, []
    for j in range(nchunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        aj, bj = a[:, sl].clone(), b[:, sl].clone()
        bj[:, 0] += aj[:, 0] * h          # the carry enters the first step
        hh = _scan_(aj, bj)
        h = hh[:, -1]
        hs.append(hh)
    return torch.cat(hs, dim=1)[:, :s], h


# ---------------------------------------------------------------------------
# Mamba (selective SSM): Hymba's SSM heads
# ---------------------------------------------------------------------------


def mamba_readout(hh: Tensor, c: Tensor) -> Tensor:
    """Mamba's readout ``y[b, s, d] = sum_n hh[b, s, d, n] c[b, s, n]`` (hh
    (B, L, d, N), c (B, L, N)): one :func:`~repro_torch.kernels.gemm.bgemm`
    over B·L (``layers.contract``), N = 1, whose dot instance sums a row's
    N states in one chain set by N alone; cuBLAS's einsum picked its kernel
    by the batch.  On the CPU the plain version folds the states in index
    order."""
    return L.contract("bsdn,bsn->bsd", hh, c)


def chunked_ssm_outputs(
    dt32: Tensor, x32: Tensor, a: Tensor, bmat: Tensor, c: Tensor,
    h0: Tensor, chunk: int,
):
    """Fused selective scan: discretize, recur and read out, per chunk, so
    only (B, chunk, d, N) tensors exist.

    dt32, x32: (B, S, d); a: (d, N); bmat, c: (B, S, N); h0: (B, d, N).
    Returns (y (B, S, d), h_last)."""
    s = x32.shape[1]
    chunk, nchunks, pad = _chunking(s, chunk)
    if pad:  # dt = 0: a_bar = 1 and bx = 0, identity steps
        dt32, x32, bmat, c = (_pad_time(t, pad) for t in (dt32, x32, bmat, c))
    h, ys = h0, []
    for j in range(nchunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        dtj, xj, bj, cj = dt32[:, sl], x32[:, sl], bmat[:, sl], c[:, sl]
        a_bar = (dtj[..., None] * a).exp_()                  # (B, L, d, N)
        bx = (dtj * xj)[..., None] * bj[:, :, None, :]
        bx[:, 0] += a_bar[:, 0] * h
        hh = _scan_(a_bar, bx)
        ys.append(mamba_readout(hh, cj))
        h = hh[:, -1]
    return torch.cat(ys, dim=1)[:, :s], h


def mamba_init_state(cfg, batch: int, dtype, device) -> dict:
    m = cfg.ssm
    di = m.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, m.conv_dim - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, m.state_dim), dtype=torch.float32,
                           device=device),
    }


class Mamba(nn.Module):
    """``in_proj``, depthwise ``conv``, ``x_proj``, ``dt_proj``, ``A_log`` and
    ``D`` (float32), ``out_proj``."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        m, d = cfg.ssm, cfg.d_model
        di = m.expand * d
        self.cfg = cfg
        self.dt_rank = m.dt_rank or -(-d // 16)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.in_proj = L.Linear(d, 2 * di, **kw)
        self.conv = L.CausalConv(di, m.conv_dim, **kw)
        self.x_proj = L.Linear(di, self.dt_rank + 2 * m.state_dim, **kw)
        self.dt_proj = L.Linear(self.dt_rank, di, bias=True, **kw)
        self.A_log = nn.Parameter(
            L.init_tensor((di, m.state_dim), "normal", generator, device,
                          torch.float32, 0.5),
            requires_grad=False,
        )
        self.D = nn.Parameter(torch.ones(di, device=device, dtype=torch.float32),
                              requires_grad=False)
        self.out_proj = L.Linear(di, d, **kw)

    def forward(self, x: Tensor, state: dict | None = None):
        """x: (B, S, d); ``state`` {"conv": (B, W-1, di), "ssm": (B, di, N)}
        or None (zeros).  Returns (out, new state)."""
        m = self.cfg.ssm
        if state is None:
            conv_state = None
            ssm_state = x.new_zeros(
                (x.shape[0], m.expand * self.cfg.d_model, m.state_dim),
                dtype=torch.float32)
        else:
            conv_state, ssm_state = state["conv"], state["ssm"]
        xi, z = self.in_proj(x).chunk(2, dim=-1)
        xi, conv_state = self.conv(xi, conv_state)
        xi = F.silu(xi)
        dt, bmat, cmat = torch.split(
            self.x_proj(xi), [self.dt_rank, m.state_dim, m.state_dim], dim=-1)
        dt = F.softplus(self.dt_proj(dt))
        a = -torch.exp(self.A_log.to(torch.float32))
        x32 = xi.to(torch.float32)
        y, h_last = chunked_ssm_outputs(
            dt.to(torch.float32), x32, a, bmat.to(torch.float32),
            cmat.to(torch.float32), ssm_state, m.chunk)
        y = (y + x32 * self.D.to(torch.float32)).to(xi.dtype)
        y = y * F.silu(z)
        return self.out_proj(y), {"conv": conv_state, "ssm": h_last}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar
# memory with recurrent weights, sequential), arXiv:2405.04517
# ---------------------------------------------------------------------------


def mlstm_zero_state(b: int, nh: int, hd: int, device=None) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((b, nh, hd, hd), **f32),
        "n": torch.zeros((b, nh, hd), **f32),
        "m": torch.full((b, nh), NEG, **f32),
    }


def mlstm_chunkwise(q, k, v, i_pre, logf, state: dict, chunk: int):
    """Chunkwise-parallel stabilized mLSTM.

    q, k, v: (B, S, nh, hd); i_pre, logf: (B, S, nh) log-domain gates;
    ``state`` {"c": (B, nh, hd, hd), "n": (B, nh, hd), "m": (B, nh)} with c
    and n stored stabilized (true C = c * exp(m)).  Per chunk, the output is
    an inter-chunk term (the decayed boundary state) plus an intra-chunk
    term (an (L, L) attention-like product).  Returns (h (B, S, nh, hd),
    last state)."""
    s = q.shape[1]
    chunk, nchunks, pad = _chunking(s, chunk)
    if pad:
        q, k, v = (_pad_time(t, pad) for t in (q, k, v))
        i_pre = _pad_time(i_pre, pad, NEG)
        logf = _pad_time(logf, pad)
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    c0, n0, m0 = state["c"], state["n"], state["m"]
    hs = []
    for j in range(nchunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        qj, kj, vj, ij, fj = q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], logf[:, sl]
        cum = torch.cumsum(fj, dim=1)                 # sum_{u<=j} logf_u
        g = torch.cummax(ij - cum, dim=1).values      # running max over i<=j
        m_all = cum + torch.maximum(m0[:, None], g)   # (B, L, nh)
        # inter-chunk: exp(cum_j + m0 - m_j) * q_j C_0
        inter_w = torch.exp(cum + m0[:, None] - m_all)
        h_inter = L.contract("blnd,bnde->blne", qj, c0) * inter_w[..., None]
        n_inter = n0[:, None] * inter_w[..., None]
        # intra-chunk: scores[j, i] = exp(cum_j - cum_i + logi_i - m_j) q_j.k_i,
        # masked before the exp
        logw = (cum[:, :, None] - cum[:, None, :] + ij[:, None, :]
                - m_all[:, :, None])                  # (B, Lq, Lk, nh)
        logw = torch.where(mask, logw, NEG)
        w_intra = torch.exp(torch.clamp(logw, max=60.0))
        scores = L.contract("blnd,bind->blin", qj, kj) * w_intra
        h_intra = L.contract("blin,bind->blnd", scores, vj)
        n_intra = L.contract("blin,bind->blnd", w_intra, kj)
        num = h_inter + h_intra
        n_all = n_inter + n_intra
        den = torch.maximum(
            torch.abs(L.contract("blnd,blnd->bln", n_all, qj)),
            torch.exp(-m_all))
        hs.append(num / den[..., None])
        # carry update, stabilized at m_last
        m_last, cum_l = m_all[:, -1], cum[:, -1]
        wc = torch.exp(cum_l + m0 - m_last)
        wi = torch.exp(cum_l[:, None] - cum + ij - m_last[:, None])
        c0 = c0 * wc[..., None, None] + L.contract(
            "blnd,blne->bnde", kj * wi[..., None], vj)
        n0 = n0 * wc[..., None] + L.contract("blnd,bln->bnd", kj, wi)
        m0 = m_last
    h = torch.cat(hs, dim=1)[:, :s]
    return h, {"c": c0, "n": n0, "m": m0}


def mlstm_step(q, k, v, i_pre, logf, state: dict):
    """One-token recurrent mLSTM update (decode).  q, k, v: (B, 1, nh, hd)."""
    qj, kj, vj = (t[:, 0].to(torch.float32) for t in (q, k, v))
    ip, lf = i_pre[:, 0], logf[:, 0]                  # (B, nh)
    c0, n0, m0 = state["c"], state["n"], state["m"]
    m_new = torch.maximum(lf + m0, ip)
    fg = torch.exp(lf + m0 - m_new)[..., None]
    ig = torch.exp(ip - m_new)[..., None]
    c = c0 * fg[..., None] + (ig * kj)[..., :, None] * vj[..., None, :]
    n = n0 * fg + ig * kj
    den = torch.maximum(torch.abs(torch.sum(n * qj, -1)), torch.exp(-m_new))
    h = torch.einsum("bnde,bnd->bne", c, qj) / den[..., None]
    return h[:, None], {"c": c, "n": n, "m": m_new}


def mlstm_init_state(cfg, batch: int, dtype, device) -> dict:
    d, nh = cfg.d_model, cfg.num_heads
    di = 2 * d
    return dict(
        conv=torch.zeros((batch, 3, di), dtype=dtype, device=device),
        **mlstm_zero_state(batch, nh, di // nh, device),
    )


class MLSTMBlock(nn.Module):
    """Pre-norm residual mLSTM block: up-projection (factor 2), causal conv,
    q/k/v and exponential gates, the mLSTM cell, output norm, gated down
    projection.  Its decode cache is {"conv", "c", "n", "m"}, each with a
    leading layer axis."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        d, nh = cfg.d_model, cfg.num_heads
        di = 2 * d
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.norm = L.RMSNorm(d, cfg.norm_eps, device=device)
        self.up = L.Linear(d, 2 * di, **kw)
        self.conv = L.CausalConv(di, 4, **kw)
        self.wq = L.Linear(di, di, **kw)
        self.wk = L.Linear(di, di, **kw)
        self.wv = L.Linear(di, di, **kw)
        self.wi = L.Linear(di, nh, bias=True, **kw)
        self.wf = L.Linear(di, nh, bias=True, **kw)
        self.out_norm = L.RMSNorm(di, cfg.norm_eps, device=device)
        self.down = L.Linear(di, d, **kw)

    def cell(self, x: Tensor, state: dict | None = None, mode: str = "train"):
        """The reference's ``mlstm_block``: returns (x + out, new state)."""
        cfg = self.cfg
        nh = cfg.num_heads
        di = 2 * cfg.d_model
        hd = di // nh
        b, s, _ = x.shape
        chunk = cfg.ssm.chunk if cfg.ssm else 256
        xm, z = self.up(self.norm(x)).chunk(2, dim=-1)
        xc, conv_state = self.conv(xm, None if state is None else state["conv"])
        xc = F.silu(xc)
        q = self.wq(xc).reshape(b, s, nh, hd)
        k = self.wk(xc).reshape(b, s, nh, hd) * (hd**-0.5)
        v = self.wv(xm).reshape(b, s, nh, hd)
        # exponential gating with log-domain stabilization
        i_pre = self.wi(xc).to(torch.float32)         # (B, S, nh)
        logf = -F.softplus(-self.wf(xc).to(torch.float32))  # log sigmoid
        mstate = (mlstm_zero_state(b, nh, hd, x.device) if state is None
                  else {key: state[key] for key in ("c", "n", "m")})
        if mode == "decode":
            hout, mstate = mlstm_step(q, k, v, i_pre, logf, mstate)
        else:
            hout, mstate = mlstm_chunkwise(q, k, v, i_pre, logf, mstate, chunk)
        hout = self.out_norm(hout.reshape(b, s, di).to(x.dtype))
        out = self.down(hout * F.silu(z))
        return x + out, {"conv": conv_state, **mstate}

    @staticmethod
    def init_cache(cfg, count: int, batch: int, slots: int, device) -> dict:
        return stacked(mlstm_init_state(cfg, batch, cfg.dtype, device), count)

    @staticmethod
    def ring(cache: dict) -> None:
        return None

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, **_,
    ) -> Tensor:
        """Block API of :mod:`repro_torch.models.blocks`: with a cache, reads
        and writes layer ``layer`` of it in place."""
        x, new = self.cell(x, layer_state(cache, layer), mode)
        store_layer_state(cache, layer, new)
        return x


def slstm_init_state(cfg, batch: int, dtype, device) -> dict:
    nh = cfg.num_heads
    hd = cfg.d_model // nh

    def z():
        return torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)

    return {"h": z(), "c": z(), "m": z(),
            "n": torch.ones((batch, nh, hd), dtype=torch.float32, device=device)}


def slstm_scan(pre: Tensor, rt: Tensor, state: dict):
    """The sLSTM time scan, one step per position.  ``pre``: the four gates'
    pre-activations (S, nh, B, 4 hd) float32, z | i | f | o on the last
    axis; ``rt``: the recurrent weights of the four gates transposed and
    stacked, (nh, hd, 4 hd), so that one batched product a step gives every
    gate's ``h @ r^T``; ``state`` {"h", "c", "n", "m"} (B, nh, hd).  The
    state runs head-major, (nh, B, hd).  Returns (h at every step (S, nh, B,
    hd), last state)."""
    hd = rt.shape[1]
    h, c, n, m = (state[k].transpose(0, 1) for k in ("h", "c", "n", "m"))
    meta = pre.device.type == "meta"
    hs = []
    for t in range(pre.shape[0]):
        # pre + h @ r^T, the reference's order      # (nh, B, 4 hd)
        g = torch.baddbmm(pre[t], h, rt) if meta else pre[t] + bgemm(h, rt)
        gz, gi, gf, go = g.split(hd, dim=-1)
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        lm = -F.softplus(-gf) + m                      # log f + m
        m_new = torch.maximum(lm, gi)
        i_g = torch.exp(gi - m_new)
        f_g = torch.exp(lm - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    last = {k: t.transpose(0, 1) for k, t in zip("hcnm", (h, c, n, m))}
    return torch.stack(hs, dim=0), last


class SLSTMBlock(nn.Module):
    """sLSTM block: a sequential time scan with block-diagonal recurrent
    weights ``rz, ri, rf, ro`` (nh, hd, hd), float32.  Its decode cache is
    {"h", "c", "n", "m"}, each with a leading layer axis."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        d, nh = cfg.d_model, cfg.num_heads
        hd = d // nh
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.norm = L.RMSNorm(d, cfg.norm_eps, device=device)
        for g in ("z", "i", "f", "o"):
            setattr(self, "w" + g, L.Linear(d, d, bias=True, **kw))
        for g in ("z", "i", "f", "o"):
            setattr(self, "r" + g, nn.Parameter(
                L.init_tensor((nh, hd, hd), "normal", generator, device,
                              torch.float32, 0.02),
                requires_grad=False))
        self.out_norm = L.RMSNorm(d, cfg.norm_eps, device=device)
        self.down = L.Linear(d, d, **kw)

    def cell(self, x: Tensor, state: dict | None = None):
        """The reference's ``slstm_block``: returns (x + out, new state)."""
        d, nh = self.cfg.d_model, self.cfg.num_heads
        hd = d // nh
        b, s, _ = x.shape
        xn = self.norm(x)
        # pre-activations of the four gates, (S, nh, B, 4 hd): step t reads
        # pre[t], and the state stays head-major, (nh, B, hd)
        pre = torch.cat(
            [getattr(self, "w" + g)(xn).to(torch.float32).reshape(b, s, nh, hd)
             for g in ("z", "i", "f", "o")], dim=-1).permute(1, 2, 0, 3).contiguous()
        # h @ r^T of every gate at once: (nh, hd, 4 hd)
        rt = torch.cat([getattr(self, "r" + g).to(torch.float32)
                        for g in ("z", "i", "f", "o")], dim=1).transpose(1, 2)
        st = slstm_init_state(self.cfg, b, x.dtype, x.device) if state is None else state
        hs, new = slstm_scan(pre, rt, st)
        hout = hs.permute(2, 0, 1, 3).reshape(b, s, d)
        hout = self.out_norm(hout.to(x.dtype))
        return x + self.down(hout), new

    @staticmethod
    def init_cache(cfg, count: int, batch: int, slots: int, device) -> dict:
        return stacked(slstm_init_state(cfg, batch, cfg.dtype, device), count)

    @staticmethod
    def ring(cache: dict) -> None:
        return None

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, **_,
    ) -> Tensor:
        """Block API of :mod:`repro_torch.models.blocks` (the same scan in
        every mode); with a cache, reads and writes layer ``layer`` of it."""
        x, new = self.cell(x, layer_state(cache, layer))
        store_layer_state(cache, layer, new)
        return x
