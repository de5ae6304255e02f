"""Recurrent Independent Mechanisms (RIMs) and their convolutional form.

Counterpart of ``ode_rl_tpu/nn/rims.py``, module for module:

* ``BlockedGrad`` (``blocked_grad``): the identity, whose gradient is
  gated by a mask;
* ``sparse_topk_renorm``: keep the attention weights above the
  (top_k + 1)-th largest (less it) and renormalise;
* ``topk_active_mask``: exactly ``topkval`` ones a row, on the blocks with
  the lowest null-key attention, ties to the lowest index (as
  ``lax.top_k``; a stable sort, since ``torch.topk`` orders ties by no
  rule);
* ``GroupLinear``: a (K, din, dout) weight, one linear map a block;
* ``BlockMultiHeadAttention``: GroupLinear projections, sparse top-k
  attention and the gated-tanh output;
* ``BlockGRUCell``: K independent GRUs as one batched einsum;
* ``BlocksCore``/``RIM``: null-key input attention picks the active
  blocks, they update, the rest keep their state; a layer a time loop;
* ``BlockConvGRUCell``/``ConvBlocksCore``/``ConvRIM``: the same in space,
  with grouped convolutions (``groups=K``) for the block-diagonal convs.

Dropout (0.5 on the RIM's output and between its layers, ``dropout`` in
the attention) is on only with ``train`` and draws a fresh mask at every
step from the caller's ``Noise`` (core/noise.py); JAX draws it from its
'dropout' rng, so the two cannot share masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import Noise
from ode_rl_torch.nn.conv_stacks import Conv, lecun_normal
from ode_rl_torch.nn.dense import Dense


class BlockedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask, None


def blocked_grad(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return BlockedGrad.apply(x, mask)


def sparse_topk_renorm(attn: torch.Tensor, top_k: int) -> torch.Tensor:
    """Rows of attention weights (..., T): keep what lies above the
    (top_k + 1)-th largest (less it), renormalise."""
    eps = 1e-7
    t = attn.shape[-1]
    k = top_k + 1
    if t <= k:
        return attn
    delta = torch.sort(attn, dim=-1).values[..., t - k, None] + eps
    w = torch.clamp(attn - delta, min=0.0)
    return w / (w.sum(dim=-1, keepdim=True) + eps)


def topk_active_mask(null_attn: torch.Tensor, topkval: int,
                     dtype=torch.float32) -> torch.Tensor:
    """(B, K) null-key attention -> (B, K) mask with ``topkval`` ones on
    the lowest entries, ties to the lowest index."""
    b, k = null_attn.shape
    if topkval >= k:
        return torch.ones((b, k), dtype=dtype, device=null_attn.device)
    order = torch.argsort(null_attn.float(), dim=-1, stable=True)
    mask = torch.zeros((b, k), dtype=dtype, device=null_attn.device)
    return mask.scatter(1, order[:, :topkval], 1.0)


def _dropout(x: torch.Tensor, rate: float, train: bool,
             noise: Noise) -> torch.Tensor:
    return noise.dropout(x, rate) if train and rate > 0.0 else x


class GroupLinear(nn.Module):
    """(B, K, din) -> (B, K, dout) with a (K, din, dout) weight ``w``,
    initialised 0.01 * N(0, 1)."""

    def __init__(self, din: int, dout: int, num_blocks: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(0.01 * torch.randn(
            (num_blocks, din, dout), generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bki,kio->bko", x, self.w.to(x.dtype))


class BlockMultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model_read: int, d_model_write: int,
                 d_model_out: int, d_k: int, d_v: int, num_blocks_read: int,
                 num_blocks_write: int, topk: int, *, residual: bool = True,
                 skip_write: bool = False, dropout: float = 0.1,
                 generator: torch.Generator):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.topk, self.residual, self.dropout = topk, residual, dropout
        self.skip_write = skip_write
        kw = dict(generator=generator)
        self.gln_qs = GroupLinear(d_model_read, n_head * d_k,
                                  num_blocks_read, **kw)
        self.gln_ks = GroupLinear(d_model_write, n_head * d_k,
                                  num_blocks_write, **kw)
        self.gln_vs = GroupLinear(d_model_write, n_head * d_v,
                                  num_blocks_write, **kw)
        # Declared whatever ``residual`` says, as in JAX; unused without it.
        self.gate_fc = Dense(n_head * d_v, d_model_out, **kw)
        if not skip_write:
            self.fc = Dense(n_head * d_v, d_model_out, **kw)

    def forward(self, q, k, v, train: bool, noise: Noise):
        b, len_q = q.shape[:2]
        len_k = k.shape[1]

        def heads(x, length, d):
            return x.reshape(b, length, self.n_head, d).transpose(1, 2)

        qh = heads(self.gln_qs(q), len_q, self.d_k)
        kh = heads(self.gln_ks(k), len_k, self.d_k)
        vh = heads(self.gln_vs(v), len_k, self.d_v)
        attn = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / self.d_k ** 0.5
        attn = sparse_topk_renorm(torch.softmax(attn, dim=-1), self.topk)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
        out = out.transpose(1, 2).reshape(b, len_q, self.n_head * self.d_v)
        gate = torch.sigmoid(self.gate_fc(out))
        if not self.skip_write:
            out = self.fc(out)
        out = _dropout(out, self.dropout, train, noise)
        if self.residual:
            out = gate * torch.tanh(out)
        return out, attn


class BlockGRUCell(nn.Module):
    """K per-block GRUs: weights ``w_i`` (K, din/K, 3h), ``w_h`` (K, h,
    3h) and biases ``b_i``, ``b_h`` (K, 3h), h = nhid / K."""

    def __init__(self, ninp: int, nhid: int, k: int, *,
                 generator: torch.Generator):
        super().__init__()
        assert ninp % k == 0 and nhid % k == 0
        self.k, self.nhid = k, nhid
        bs_in, bs_h = ninp // k, nhid // k
        self.w_i = lecun_normal((k, bs_in, 3 * bs_h), k * bs_in, generator)
        self.w_h = lecun_normal((k, bs_h, 3 * bs_h), k * bs_h, generator)
        self.b_i = nn.Parameter(torch.zeros(k, 3 * bs_h))
        self.b_h = nn.Parameter(torch.zeros(k, 3 * bs_h))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        xb = x.reshape(b, self.k, -1)
        hb = h.reshape(b, self.k, -1)
        gi = torch.einsum("bki,kio->bko", xb, self.w_i.to(x.dtype)) + self.b_i
        gh = torch.einsum("bki,kio->bko", hb, self.w_h.to(x.dtype)) + self.b_h
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return ((1.0 - z) * n + z * hb).reshape(b, self.nhid)


class BlocksCore(nn.Module):
    """One RIM layer step on (B, ninp) and the state (B, n_hid)."""

    def __init__(self, ninp: int, n_hid: int, num_blocks_in: int,
                 num_blocks_out: int, topkval: int, *, step_att: bool = True,
                 sparse_comm: bool = False, num_modules_read_input: int = 2,
                 dropout: float = 0.1, generator: torch.Generator):
        super().__init__()
        self.ninp, self.n_hid = ninp, n_hid
        self.num_blocks_in, self.num_blocks_out = num_blocks_in, num_blocks_out
        self.topkval, self.step_att = topkval, step_att
        self.sparse_comm, self.reads = sparse_comm, num_modules_read_input
        bs_out = n_hid // num_blocks_out
        self.bs_out, self.att_out = bs_out, 4 * bs_out
        kw = dict(generator=generator)
        self.inp_att = BlockMultiHeadAttention(
            1, bs_out, ninp, self.att_out, 64, self.att_out, num_blocks_out,
            num_modules_read_input, num_blocks_in + 1, residual=False,
            skip_write=True, dropout=dropout, **kw)
        self.block_gru = BlockGRUCell(self.att_out * num_blocks_out, n_hid,
                                      num_blocks_out, **kw)
        if sparse_comm and step_att:
            self.comm_att = BlockMultiHeadAttention(
                4, bs_out, bs_out, bs_out, 16, 16, num_blocks_out,
                num_blocks_out, num_blocks_out, residual=True,
                dropout=dropout, **kw)

    def forward(self, inp, hx, train: bool, noise: Noise,
                do_block: bool = True):
        b, k, bs = inp.shape[0], self.num_blocks_out, self.bs_out
        inp_use = inp.reshape(b, self.num_blocks_in, self.ninp).repeat(
            1, self.reads - 1, 1)
        inp_use = torch.cat([torch.zeros_like(inp_use[:, :1]), inp_use], 1)
        attended, iatt = self.inp_att(hx.reshape(b, k, bs), inp_use, inp_use,
                                      train, noise)
        attended = attended.reshape(b, self.att_out * k)
        mask_blocks = topk_active_mask(iatt[:, 0, :, 0], self.topkval,
                                       hx.dtype)
        mask = mask_blocks.repeat_interleave(bs, dim=-1).detach()
        hx_new = self.block_gru(attended, hx)
        if do_block and self.sparse_comm and self.step_att:
            hb = hx_new.reshape(b, k, bs)
            hb_masked = blocked_grad(hb, mask.reshape(b, k, bs))
            delta, _ = self.comm_att(hb_masked, hb_masked, hb_masked, train,
                                     noise)
            hx_new = (hb + delta).reshape(b, self.n_hid)
        return mask * hx_new + (1.0 - mask) * hx, mask


class RIM(nn.Module):
    """Layers of BlocksCore over time: (B, T, ninp) -> (outputs (B, T,
    n_hid[-1]), the final state of each layer)."""

    def __init__(self, ninp: int, n_hid, num_blocks, topk, *,
                 sparse_comm: bool = False, use_inactive: bool = True,
                 use_blocked_grad: bool = False, dropout: float = 0.5,
                 generator: torch.Generator):
        super().__init__()
        self.n_hid, self.dropout = list(n_hid), dropout
        self.use_inactive, self.use_blocked_grad = (use_inactive,
                                                    use_blocked_grad)
        for i, nh in enumerate(self.n_hid):
            self.add_module(f"core_{i}", BlocksCore(
                ninp if i == 0 else self.n_hid[i - 1], nh, 1, num_blocks[i],
                topk[i], sparse_comm=sparse_comm, dropout=dropout,
                generator=generator))

    def forward(self, xs, h0=None, train: bool = True, noise: Noise = None):
        b, t = xs.shape[:2]
        layer_input, final_hidden = xs, []
        nlayers = len(self.n_hid)
        for i in range(nlayers):
            core = getattr(self, f"core_{i}")
            h = (h0[i] if h0 is not None else torch.zeros(
                (b, self.n_hid[i]), dtype=xs.dtype, device=xs.device))
            hs, masks = [], []
            for step in range(t):
                h, mask = core(layer_input[:, step], h, train, noise)
                hs.append(h)
                masks.append(mask)
            final_hidden.append(h)
            hs, masks = torch.stack(hs, 1), torch.stack(masks, 1)
            if i < nlayers - 1:
                out = blocked_grad(hs, masks) if self.use_blocked_grad else hs
                if not self.use_inactive:
                    out = masks * out
                layer_input = _dropout(out, self.dropout, train, noise)
            else:
                layer_input = hs
        return _dropout(layer_input, self.dropout, train, noise), final_hidden


class GroupedConv(nn.Module):
    """A SAME stride-1 conv with ``groups`` groups on NHWC: OIHW weight
    (cout, cin / groups, kh, kw), the layout torch's grouped conv takes
    (flax's ``feature_group_count``)."""

    def __init__(self, cin: int, cout: int, groups: int, kernel_size: int,
                 *, generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.groups, self.padding = groups, k // 2
        self.weight = lecun_normal((cout, cin // groups, k, k),
                                   k * k * cin // groups, generator)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1) + self.bias.to(x.dtype)


class BlockConvGRUCell(nn.Module):
    """K per-block ConvGRUs as grouped convs (``gates``, ``cand``) over
    [x | h] interleaved block by block."""

    def __init__(self, nhid: int, k: int, kernel_size: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        assert nhid % k == 0
        self.nhid, self.k, self.bs = nhid, k, nhid // k
        self.gates = GroupedConv(2 * nhid, 2 * nhid, k, kernel_size,
                                 generator=generator)
        self.cand = GroupedConv(2 * nhid, nhid, k, kernel_size,
                                generator=generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        b, hh, ww, _ = x.shape
        k, bs = self.k, self.bs
        xb = x.reshape(b, hh, ww, k, bs)
        hb = h.reshape(b, hh, ww, k, bs)
        xh = torch.cat([xb, hb], dim=-1).reshape(b, hh, ww, 2 * self.nhid)
        gates = self.gates(xh).reshape(b, hh, ww, k, 2 * bs)
        r, z = torch.sigmoid(gates).chunk(2, dim=-1)
        xrh = torch.cat([xb, r * hb], dim=-1).reshape(b, hh, ww,
                                                      2 * self.nhid)
        n = torch.tanh(self.cand(xrh)).reshape(b, hh, ww, k, bs)
        return ((1.0 - z) * n + z * hb).reshape(b, hh, ww, self.nhid)


class ConvBlocksCore(nn.Module):
    """One conv-RIM step on (B, H, W, in_ch) and the state (B, H, W,
    n_hid): pooled descriptors compete against a null key, the frame is
    lifted to K blocks by ``inp_proj`` and biased by each block's read
    (``att_film``), the active blocks update, the rest keep their state."""

    def __init__(self, in_ch: int, n_hid: int, num_blocks_out: int,
                 topkval: int, kernel_size: int = 3, *,
                 sparse_comm: bool = False, num_modules_read_input: int = 2,
                 dropout: float = 0.1, generator: torch.Generator):
        super().__init__()
        k = num_blocks_out
        self.n_hid, self.k, self.bs = n_hid, k, n_hid // k
        self.att_out = 4 * self.bs
        self.topkval, self.sparse_comm = topkval, sparse_comm
        self.reads = num_modules_read_input
        kw = dict(generator=generator)
        self.inp_att = BlockMultiHeadAttention(
            1, self.bs, in_ch, self.att_out, 64, self.att_out, k,
            num_modules_read_input, num_modules_read_input, residual=False,
            skip_write=True, dropout=dropout, **kw)
        self.inp_proj = Conv(in_ch, n_hid, kernel_size,
                             padding=kernel_size // 2, **kw)
        self.att_film = GroupLinear(self.att_out, self.bs, k, **kw)
        self.block_cgru = BlockConvGRUCell(n_hid, k, kernel_size, **kw)
        if sparse_comm:
            self.comm_att = BlockMultiHeadAttention(
                4, self.bs, self.bs, self.bs, 16, 16, k, k, k,
                residual=True, dropout=dropout, **kw)

    def forward(self, inp, hx, train: bool, noise: Noise):
        b = inp.shape[0]
        k, bs = self.k, self.bs
        q = hx.mean(dim=(1, 2)).reshape(b, k, bs)
        inp_use = inp.mean(dim=(1, 2))[:, None, :].repeat(1, self.reads - 1,
                                                           1)
        inp_use = torch.cat([torch.zeros_like(inp_use[:, :1]), inp_use], 1)
        attended, iatt = self.inp_att(q, inp_use, inp_use, train, noise)
        mask_blocks = topk_active_mask(iatt[:, 0, :, 0], self.topkval,
                                       hx.dtype).detach()
        film = self.att_film(attended.reshape(b, k, self.att_out))
        x_blocks = self.inp_proj(inp) + film.reshape(b, 1, 1, self.n_hid)
        hx_new = self.block_cgru(x_blocks, hx)
        if self.sparse_comm:
            pooled = hx_new.mean(dim=(1, 2)).reshape(b, k, bs)
            pooled = blocked_grad(
                pooled, mask_blocks[..., None].expand(b, k, bs))
            delta, _ = self.comm_att(pooled, pooled, pooled, train, noise)
            hx_new = hx_new + delta.reshape(b, 1, 1, self.n_hid)
        mask = mask_blocks.repeat_interleave(bs, dim=-1)[:, None, None, :]
        return mask * hx_new + (1.0 - mask) * hx, mask_blocks


class ConvRIM(nn.Module):
    """ConvBlocksCore (``core``) over time: (B, T, H, W, in_ch) ->
    (states (B, T, H, W, n_hid), the last state, masks (B, T, K))."""

    def __init__(self, in_ch: int, n_hid: int, num_blocks: int, topk: int,
                 kernel_size: int = 3, *, sparse_comm: bool = False,
                 dropout: float = 0.1, generator: torch.Generator):
        super().__init__()
        self.n_hid = n_hid
        self.core = ConvBlocksCore(in_ch, n_hid, num_blocks, topk,
                                   kernel_size, sparse_comm=sparse_comm,
                                   dropout=dropout, generator=generator)

    def forward(self, xs, h0=None, train: bool = True, noise: Noise = None):
        b, t, hh, ww, _ = xs.shape
        h = (torch.zeros((b, hh, ww, self.n_hid), dtype=xs.dtype,
                         device=xs.device) if h0 is None else h0)
        hs, masks = [], []
        for step in range(t):
            h, mask = self.core(xs[:, step], h, train, noise)
            hs.append(h)
            masks.append(mask)
        return torch.stack(hs, 1), h, torch.stack(masks, 1)
