"""Recurrent mixers: RG-LRU (Griffin / RecurrentGemma), mLSTM and sLSTM
(xLSTM) in train, prefill and decode modes (counterpart of
``repro/models/recurrent.py``: the same function names, parameter keys and
shapes, the same float32 arithmetic in the same order).

Each mixer is ``forward(params, x, *, cfg, mode, state) -> (y, new_state)``
with ``state`` the O(1)-per-token decode state (None in train mode). The
functions return new state tensors; ``transformer.apply_block`` copies a
decode step's state into the serving cache in place.

- RG-LRU: a depthwise causal conv (the reference's K-term sum of shifted
  products, summed in its order), the gates, and the linear recurrence
  h_t = a_t h_{t-1} + b_t over S by :func:`_associative_scan`, the odd/even
  recursion of ``jax.lax.associative_scan`` written out (its combine order,
  ~2 log2 S levels of elementwise work); decode (S == 1) is the one-step
  update.
- mLSTM: the chunkwise-parallel form, a loop over chunks of
  ``mlstm_chunk`` positions carrying (C, n, m) (the reference's
  ``lax.scan``), the trailing partial chunk after it. One deliberate
  difference: the within-chunk decay is masked before its exp, not after
  (see ``_mlstm_chunk``), so that a closed forget gate cannot turn every
  gradient into NaN; the numbers are otherwise the reference's.
- sLSTM: a loop over S steps (the recurrence is on h).

Each mixer has the reference's logical specs of its parameters and of its
decode state (``spec_rglru``, ``spec_rglru_state``, ...; plain tuples).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation, dense_init

# the stabiliser's initial value (m of an empty mLSTM / sLSTM state)
M_INIT = -1e30


# ---------------------------------------------------------------------------
# RG-LRU (Real-Gated Linear Recurrent Unit) block
# ---------------------------------------------------------------------------


def _rnn_width(cfg: ModelConfig) -> int:
    return cfg.recurrent.width or cfg.d_model


def init_rglru(generator, cfg: ModelConfig, *, device, dtype=torch.float32):
    d, dr = cfg.d_model, _rnn_width(cfg)
    K = cfg.recurrent.conv_size

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, device=device, dtype=dtype)

    p = {"w_gate_branch": dense(d, dr), "w_x": dense(d, dr)}
    p["conv_w"] = (torch.randn((K, dr), generator=generator, device=device,
                               dtype=torch.float32)
                   * (1.0 / math.sqrt(K))).to(dtype)
    p["w_a"] = dense(dr, dr)
    p["w_i"] = dense(dr, dr)
    # lam so that a = sigmoid(lam) = sqrt(u), u ~ U[0.9^2, 0.999^2]
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = torch.rand((dr,), generator=generator, device=device,
                   dtype=torch.float32) * (hi - lo) + lo
    a = u ** 0.5
    p["lam"] = torch.log(a / (1 - a))
    p["w_out"] = dense(dr, d)
    zeros = dict(device=device, dtype=dtype)
    p["conv_b"] = torch.zeros((dr,), **zeros)
    p["b_a"] = torch.zeros((dr,), **zeros)
    p["b_i"] = torch.zeros((dr,), **zeros)
    return p


def spec_rglru():
    return {"w_gate_branch": ("fsdp", "model"), "w_x": ("fsdp", "model"),
            "conv_w": (None, "model"), "conv_b": ("model",),
            "w_a": ("fsdp", "model"), "b_a": ("model",),
            "w_i": ("fsdp", "model"), "b_i": ("model",),
            "lam": ("model",), "w_out": ("model", "fsdp")}


def _causal_conv(u, w, b, carry=None):
    """u: (B, S, dr); w: (K, dr) depthwise causal conv; carry: (B, K-1, dr)
    of the previous inputs (zeros when None). Returns (out, new carry)."""
    K = w.shape[0]
    if carry is None:
        pad = torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = carry.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, S+K-1, dr)
    # Python's sum: 0 + t0 + t1 + ..., the reference's order
    out = sum(full[:, i:i + u.shape[1]] * w[i] for i in range(K))
    new_carry = full[:, full.shape[1] - (K - 1):]
    return out + b, new_carry


def _interleave(even, odd, dim):
    """even[0], odd[0], even[1], odd[1], ... along ``dim``; ``even`` has as
    many entries as ``odd`` or one more."""
    n = odd.shape[dim]
    pairs = torch.stack([even.narrow(dim, 0, n), odd], dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, even.narrow(dim, n, 1)], dim)
    return out


def _associative_scan(a, b, dim):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along ``dim`` (h_{-1} = 0),
    as ``jax.lax.associative_scan`` with the combine (a1, b1), (a2, b2) ->
    (a1 a2, a2 b1 + b2) computes it: the adjacent pairs combined, the half
    scanned by recursion, the evens fixed up from it, the two interleaved.
    Returns (the running products of a, h)."""
    n = a.shape[dim]
    if n < 2:
        return a, b

    def sl(t, start, stop, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    a1, b1 = sl(a, 0, n - 1, 2), sl(b, 0, n - 1, 2)
    a2, b2 = sl(a, 1, n, 2), sl(b, 1, n, 2)
    odd_a, odd_b = _associative_scan(a1 * a2, a2 * b1 + b2, dim)
    if n % 2 == 0:
        pa, pb = sl(odd_a, 0, -1), sl(odd_b, 0, -1)
    else:
        pa, pb = odd_a, odd_b
    ea, eb = sl(a, 2, n, 2), sl(b, 2, n, 2)
    even_a = torch.cat([sl(a, 0, 1), pa * ea], dim)
    even_b = torch.cat([sl(b, 0, 1), ea * pb + eb], dim)
    return _interleave(even_a, odd_a, dim), _interleave(even_b, odd_b, dim)


def rglru_forward(params, x, *, cfg: ModelConfig, mode: str, state=None):
    r = cfg.recurrent
    B, S, _ = x.shape
    gate_branch = activation("gelu")(x @ params["w_gate_branch"])
    u = x @ params["w_x"]
    conv_carry = None if state is None else state["conv"]
    u, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"],
                               conv_carry)

    rt = torch.sigmoid(u @ params["w_a"] + params["b_a"]).to(torch.float32)
    it = torch.sigmoid(u @ params["w_i"] + params["b_i"])
    log_a = F.logsigmoid(params["lam"])  # log sigmoid(lam) = log a
    log_at = r.lru_c * rt * log_a  # (B, S, dr)
    at = torch.exp(log_at)
    gated_in = (torch.sqrt(torch.clamp(1.0 - at * at, min=1e-12))
                * (it * u).to(torch.float32))

    h0 = None if state is None else state["h"].to(torch.float32)
    if mode == "decode" and S == 1:
        h = at[:, 0] * h0 + gated_in[:, 0]
        hs = h[:, None]
    else:
        if h0 is not None:
            gated_in = torch.cat([gated_in[:, :1] + at[:, :1] * h0[:, None],
                                  gated_in[:, 1:]], dim=1)
        _, hs = _associative_scan(at, gated_in, 1)  # (B, S, dr)
        h = hs[:, -1]
    y = (gate_branch * hs.to(x.dtype)) @ params["w_out"]
    new_state = None
    if mode != "train":
        new_state = {"h": h, "conv": new_conv}
    return y, new_state


def init_rglru_state(cfg: ModelConfig, B: int, *, device,
                     dtype=torch.float32):
    dr, K = _rnn_width(cfg), cfg.recurrent.conv_size
    return {"h": torch.zeros((B, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, K - 1, dr), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM), chunkwise-parallel
# ---------------------------------------------------------------------------


def spec_rglru_state():
    return {"h": ("data", "model"), "conv": ("data", None, "model")}


def init_mlstm(generator, cfg: ModelConfig, *, device, dtype=torch.float32):
    d = cfg.d_model
    H = cfg.recurrent.num_heads

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, device=device, dtype=dtype)

    p = {"wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
         "w_if": dense(d, 2 * H), "w_og": dense(d, d), "w_out": dense(d, d)}
    p["b_if"] = torch.cat([torch.zeros((H,), device=device),
                           3.0 * torch.ones((H,), device=device)]).to(dtype)
    p["gn_scale"] = torch.ones((d,), device=device, dtype=dtype)
    return p


def spec_mlstm():
    return {"wq": ("fsdp", "model"), "wk": ("fsdp", "model"),
            "wv": ("fsdp", "model"), "w_if": ("fsdp", None),
            "b_if": (None,), "w_og": ("fsdp", "model"),
            "gn_scale": ("model",), "w_out": ("model", "fsdp")}


def _headify(x, H):
    B, S, d = x.shape
    return x.reshape(B, S, H, d // H).transpose(1, 2)  # (B, H, S, dh)


def _mlstm_chunk(q, k, v, logf, logi, state):
    """One chunk. q, k, v: (B, H, c, dh); logf, logi: (B, H, c); state
    (C (B, H, dh, dh), n (B, H, dh), m (B, H)). Returns (h, state)."""
    C0, n0, m0 = state
    c = q.shape[2]
    b = torch.cumsum(logf, dim=-1)  # (B, H, c)
    u = logi - b
    M = torch.maximum(m0[..., None], torch.cummax(u, dim=2).values)
    # within-chunk decay D[t, s] = exp(u_s - M_t) for s <= t, 0 above the
    # diagonal. The exponent is masked to -inf BEFORE the exp: the
    # reference masks after it, and once u_s - M_t passes ~88 for some
    # s > t (a forget gate closed over a few steps) its exp overflows to
    # inf there, the mask's zero gradient times inf is NaN, and every
    # gradient of the model is NaN. Wherever the reference's gradient is
    # finite the two are equal bit for bit (exp(-inf) = 0 exactly).
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    D = torch.exp(torch.where(tri, u[..., None, :] - M[..., None],
                              -torch.inf))  # (B, H, c, c)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * D
    intra = torch.einsum("bhts,bhsd->bhtd", scores, v)
    # the denominator's gate weights D (without q.k): n_t = sum_s D k_s
    intra_n = torch.einsum("bhts,bhsd->bhtd", D, k)
    decay0 = torch.exp(m0[..., None] - M)  # (B, H, c)
    inter = torch.einsum("bhtd,bhde->bhte", q, C0) * decay0[..., None]
    inter_n = torch.einsum("bhtd,bhd->bht", q, n0) * decay0
    m_t = b + M
    num = intra + inter
    n_dot_q = inter_n + torch.sum(intra_n * q, dim=-1)
    h = num / torch.maximum(torch.abs(n_dot_q), torch.exp(-m_t))[..., None]
    # end-of-chunk state
    b_end = b[..., -1]
    M_end = torch.maximum(m0, torch.amax(u, dim=-1))
    a_w = torch.exp(u - M_end[..., None])
    carry = torch.exp(m0 - M_end)
    C1 = (carry[..., None, None] * C0
          + torch.einsum("bhs,bhsd,bhse->bhde", a_w, k, v))
    n1 = carry[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", a_w, k)
    m1 = b_end + M_end
    return h, (C1, n1, m1)


def mlstm_forward(params, x, *, cfg: ModelConfig, mode: str, state=None):
    r = cfg.recurrent
    H = r.num_heads
    B, S, d = x.shape
    dh = d // H
    q = _headify(x @ params["wq"], H) * (1.0 / math.sqrt(dh))
    k = _headify(x @ params["wk"], H) * (1.0 / math.sqrt(dh))
    v = _headify(x @ params["wv"], H)
    gates = (x @ params["w_if"] + params["b_if"]).to(torch.float32)
    logi = gates[..., :H].transpose(1, 2)  # (B, H, S) pre-activation i
    logf = F.logsigmoid(gates[..., H:]).transpose(1, 2)

    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        st = (torch.zeros((B, H, dh, dh), **f32),
              torch.zeros((B, H, dh), **f32),
              torch.full((B, H), M_INIT, **f32))
    else:
        st = (state["C"], state["n"], state["m"])

    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    if S == 1 and mode == "decode":
        h, st = _mlstm_chunk(qf, kf, vf, logf, logi, st)
    else:
        c = min(r.mlstm_chunk, S)
        hs = []
        for lo in range(0, S - S % c, c):
            sl = slice(lo, lo + c)
            hc, st = _mlstm_chunk(qf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
                                  logf[:, :, sl], logi[:, :, sl], st)
            hs.append(hc)
        if S % c:  # the trailing partial chunk
            sl = slice(S - S % c, S)
            hc, st = _mlstm_chunk(qf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
                                  logf[:, :, sl], logi[:, :, sl], st)
            hs.append(hc)
        h = torch.cat(hs, dim=2)

    h = h.transpose(1, 2)  # (B, S, H, dh)
    # per-head group norm
    mu = torch.mean(h, -1, keepdim=True)
    var = torch.mean(torch.square(h - mu), -1, keepdim=True)
    h = ((h - mu) * torch.rsqrt(var + 1e-6)).reshape(B, S, d)
    h = h * params["gn_scale"]
    og = torch.sigmoid(x @ params["w_og"])
    y = (og * h.to(x.dtype)) @ params["w_out"]
    new_state = None
    if mode != "train":
        new_state = {"C": st[0], "n": st[1], "m": st[2]}
    return y, new_state


def init_mlstm_state(cfg: ModelConfig, B: int, *, device):
    H = cfg.recurrent.num_heads
    dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, H, dh, dh), **f32),
            "n": torch.zeros((B, H, dh), **f32),
            "m": torch.full((B, H), M_INIT, **f32)}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with recurrent connections), sequential
# ---------------------------------------------------------------------------


def spec_mlstm_state():
    return {"C": ("data", "model", None, None), "n": ("data", "model", None),
            "m": ("data", "model")}


def init_slstm(generator, cfg: ModelConfig, *, device, dtype=torch.float32):
    d = cfg.d_model
    H = cfg.recurrent.num_heads
    dh = d // H
    p = {"w_gates": dense_init(generator, d, 4 * d, device=device,
                               dtype=dtype)}  # z, i, f, o
    p["r_gates"] = (torch.randn((4, H, dh, dh), generator=generator,
                                device=device, dtype=torch.float32)
                    * (1.0 / math.sqrt(dh))).to(dtype)
    p["w_out"] = dense_init(generator, d, d, device=device, dtype=dtype)
    p["b_gates"] = torch.cat([torch.zeros((2 * d,), device=device),
                              3.0 * torch.ones((d,), device=device),
                              torch.zeros((d,), device=device)]).to(dtype)
    p["gn_scale"] = torch.ones((d,), device=device, dtype=dtype)
    return p


def spec_slstm():
    return {"w_gates": ("fsdp", None), "r_gates": (None, "model", None, None),
            "b_gates": (None,), "gn_scale": ("model",),
            "w_out": ("model", "fsdp")}


def _slstm_step(params, carry, wx_t, H, dh):
    """carry: (c, n, h, m) each (B, d = H dh); wx_t: (B, 4d) the input
    projection of this step. Returns (carry, h)."""
    c0, n0, h0, m0 = carry
    B = c0.shape[0]
    h_heads = h0.reshape(B, H, dh)
    rec = torch.einsum("bhd,ghde->bghe", h_heads.to(torch.float32),
                       params["r_gates"].to(torch.float32)).reshape(
                           B, 4, H * dh)
    pre = wx_t.to(torch.float32).reshape(B, 4, H * dh) + rec
    z = torch.tanh(pre[:, 0])
    i_t = pre[:, 1]
    f_t = pre[:, 2]
    o = torch.sigmoid(pre[:, 3])
    logf = F.logsigmoid(f_t)
    m1 = torch.maximum(logf + m0, i_t)
    ip = torch.exp(i_t - m1)
    fp = torch.exp(logf + m0 - m1)
    c1 = fp * c0 + ip * z
    n1 = fp * n0 + ip
    h1 = o * (c1 / torch.clamp(n1, min=1e-9))
    return (c1, n1, h1, m1), h1


def slstm_forward(params, x, *, cfg: ModelConfig, mode: str, state=None):
    r = cfg.recurrent
    H = r.num_heads
    B, S, d = x.shape
    dh = d // H
    wx = x @ params["w_gates"] + params["b_gates"]  # (B, S, 4d)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        carry = tuple(torch.zeros((B, d), **f32) for _ in range(3)) + (
            torch.full((B, d), M_INIT, **f32),)
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])

    hs = []
    for t in range(S):
        carry, h1 = _slstm_step(params, carry, wx[:, t], H, dh)
        hs.append(h1)
    hs = torch.stack(hs, dim=1)  # (B, S, d)

    # per-head group norm
    hh = hs.reshape(B, S, H, dh)
    mu = torch.mean(hh, -1, keepdim=True)
    var = torch.mean(torch.square(hh - mu), -1, keepdim=True)
    hn = ((hh - mu) * torch.rsqrt(var + 1e-6)).reshape(B, S, d)
    y = (hn * params["gn_scale"]).to(x.dtype) @ params["w_out"]
    new_state = None
    if mode != "train":
        new_state = {"c": carry[0], "n": carry[1], "h": carry[2],
                     "m": carry[3]}
    return y, new_state


def init_slstm_state(cfg: ModelConfig, B: int, *, device):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((B, d), **f32), "n": torch.zeros((B, d), **f32),
            "h": torch.zeros((B, d), **f32),
            "m": torch.full((B, d), M_INIT, **f32)}


def spec_slstm_state():
    return {"c": ("data", "model"), "n": ("data", "model"),
            "h": ("data", "model"), "m": ("data", "model")}
