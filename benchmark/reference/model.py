"""The GAOT-3D forward of a configuration file, in plain PyTorch, on one mesh.

`Spec.from_config` reads the configuration; `forward` takes a dict of
weights under the state-dict names of the model (`encoder.lifting.fcs.0.weight`,
...), the points [N, 3] and their features [N, C_in], and returns the
prediction [N, C_out]. With `seeds` (one 64-bit seed a processor block) it is
a training forward with attention-probability dropout.

  encoder: lifted = lifting(feats); every joined (point, cell) edge adds
    [ kmlp([point | cell]) * lifted(point) | 1 | d | y | y y^T (6) ] to its
    cell (y = point - cell, d = |y|); the GNO mean is the value columns over
    the cell's edge count; the statistical features of a cell are [count,
    mean d, var d, mean y, eigenvalues of cov(y) + 1e-6 I, descending, those
    under 1e-3 of the first set to 0], zero for an empty cell, z-normalised
    over the cells (unbiased std, 1 where under 1e-6) and fed through
    Linear-ReLU-Linear; recovery(cat[gno mean, geo]);
  processor: 2x2x2 patches, patch_linear, num_layers // 2 blocks pushing
    skips, as many blocks taking skip_proj(cat[x, skip]); a block is
    h = x + attn(rmsnorm(x)); h = rmsnorm(h); h + w2(silu(w1 h) * w3 h);
    attention has bias-free q, k, v, o projections, 1-D sequence-order
    rotary on q and k (interleaved pairs, theta 10000);
  decoder: each point's value is the mean over its joined cells of
    kmlp([cell | point]) * latent(cell), then Linear-GELU-Linear.
The kernel MLPs have exact GELU between layers; under `kernel_dtype:
bfloat16` each layer's input and weight are rounded to bf16 and multiplied
with an f32 result, bias and GELU in f32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .graph import Grid, joined_cells, undecided
from .philox import keep_rows

Weights = Dict[str, torch.Tensor]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _operand(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """x's value rounded as a lower-precision product reads it; its
    gradient passes as x's."""
    return x + (rounded - x).detach()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x in float8 e4m3 with one scale (its largest magnitude at 448), held
    in f32: what an fp8 product reads of an operand."""
    xf = x.detach().float()
    scale = xf.abs().amax().clamp_min(1e-30) / 448.0
    return _operand(x.float(), (xf / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (to nearest even), held in f32:
    what a TF32 tensor-core product reads of an f32 operand."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & ~0x1FFF
    return _operand(x, bits.view(torch.float32))


@dataclass
class Spec:
    grid: Grid
    radius: float
    budget: int
    kernel_bf16: bool
    attention_bf16: bool
    heads: int
    layers: int
    patch: int
    norm_eps: float
    dropout: float
    enc_layers: int  # layers of the encoder's kernel MLP
    dec_layers: int
    chunk: int = 65536
    attn_rows: int = 1024
    # the controls: "tf32", every f32 product on TF32-rounded operands; "fp8",
    # every operand the configuration states in bf16 rounded to e4m3 instead,
    # with one scale a tensor; "bf16_kernel", the kernel MLPs' operands in
    # bf16 where the configuration states f32; and the fault "half_batch"
    # (optim.train_steps)
    control: Optional[str] = None

    @staticmethod
    def from_config(cfg: dict) -> "Spec":
        m = cfg["model"]
        magno, tr = m["magno"], m["transformer"]
        dims = m["latent_tokens"]
        return Spec(
            grid=Grid(dims), radius=float(magno["gno_radius"]),
            budget=int(magno["slot_budget"]),
            kernel_bf16=magno.get("kernel_dtype", "float32") == "bfloat16",
            attention_bf16=tr["attn_config"].get("attention_dtype", "bfloat16") == "bfloat16",
            heads=int(tr["attn_config"]["num_heads"]), layers=int(tr["num_layers"]),
            patch=int(tr["patch_size"]), norm_eps=float(tr["norm_eps"]),
            dropout=float(tr["attn_config"]["atten_dropout"]),
            enc_layers=len(magno["in_gno_channel_mlp_hidden_layers"]) + 1,
            dec_layers=len(magno["out_gno_channel_mlp_hidden_layers"]) + 1,
            chunk=int(magno["edge_chunk_size"]))


def kernel_mlp(x: torch.Tensor, W: Weights, prefix: str, n: int, spec: "Spec") -> torch.Tensor:
    for i in range(n):
        name = f"{prefix}.{i}"
        if spec.kernel_bf16 or spec.control == "bf16_kernel":
            low = round_fp8 if spec.control == "fp8" and spec.kernel_bf16 else round_bf16
            x = F.linear(low(x), low(W[f"{name}.weight"]), W[f"{name}.bias"])
        else:
            x = dense(x, W, name, spec)
        if i < n - 1:
            x = F.gelu(x)
    return x


def dense(x: torch.Tensor, W: Weights, name: str, spec: "Spec") -> torch.Tensor:
    w = W[f"{name}.weight"]
    if spec.control == "tf32":
        x, w = round_tf32(x), round_tf32(w)
    return F.linear(x, w, W.get(f"{name}.bias"))


def graph(spec: Spec, pos: torch.Tensor):
    """The joined cells of every point: (cells [N, budget], valid [N, budget])."""
    with torch.no_grad():
        return joined_cells(pos, spec.grid, spec.radius, spec.budget, spec.chunk)


SPARSE_CELL = 64  # joined edges under which one edge moves a cell's mean by over 1.5%


def compared(spec: Spec, pos: torch.Tensor, cells: torch.Tensor,
             valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points bool [N], cells bool [M]) that the comparison holds: the
    cells that no undecided point (graph.undecided) may join or not, and
    the points that are not undecided and are joined to no sparse cell
    (under SPARSE_CELL edges) that an undecided point may join or not,
    whose latent one edge changes."""
    with torch.no_grad():
        nodes, touched = undecided(pos, spec.grid, spec.radius, chunk=spec.chunk)
        edges = torch.bincount(cells[valid], minlength=spec.grid.cells)
        fragile = touched & (edges < SPARSE_CELL)
        return ~(nodes | (fragile[cells] & valid).any(dim=1)), ~touched


def valid_edges(valid: torch.Tensor) -> int:
    return int(valid.sum())


# -- encoder -----------------------------------------------------------------


def _moments(y: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    y0, y1, y2 = y[:, 0:1], y[:, 1:2], y[:, 2:3]
    return torch.cat([torch.ones_like(d), d, y, y0 * y0, y0 * y1, y0 * y2, y1 * y1, y1 * y2,
                      y2 * y2], dim=-1)


def _cell_features(moments: torch.Tensor) -> torch.Tensor:
    """[M, 11] moment sums -> [M, 9] statistical features."""
    cnt, d_sum, y_sum, yy = moments[:, 0], moments[:, 1], moments[:, 2:5], moments[:, 5:]
    n = cnt.clamp_min(1.0)
    ybar = y_sum / n[:, None]
    d_avg = d_sum / n
    d_var = ((yy[:, 0] + yy[:, 3] + yy[:, 5]) / n - d_avg * d_avg).clamp_min(0.0)
    m = yy / n[:, None]
    cov = torch.stack([m[:, 0], m[:, 1], m[:, 2], m[:, 1], m[:, 3], m[:, 4],
                       m[:, 2], m[:, 4], m[:, 5]], dim=-1).reshape(-1, 3, 3)
    cov = cov - ybar[:, :, None] * ybar[:, None, :]
    cov = cov + 1e-6 * torch.eye(3, dtype=cov.dtype, device=cov.device)
    # float64 on the host: cuSOLVER's batched solver refuses a batch of this size
    eig = torch.linalg.eigvalsh(cov.double().cpu()).flip(-1).float().to(cov.device)
    eig = torch.where(eig > 1e-3 * eig[:, :1], eig, torch.zeros_like(eig))
    feats = torch.cat([cnt[:, None], d_avg[:, None], d_var[:, None], ybar, eig], dim=-1)
    return torch.where((cnt > 0)[:, None], feats, torch.zeros_like(feats))


def _znorm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=0, keepdim=True)
    std = x.std(dim=0, keepdim=True, correction=1)
    std = torch.where(std < 1e-6, torch.ones_like(std), std)
    return (x - mean) / std


def encode_parts(W: Weights, spec: Spec, pos, feats, cells,
                 valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points -> (GNO mean [M, C], statistical geoembed [M, C]), the two
    halves the recovery layer reads."""
    lifted = dense(feats, W, "encoder.lifting.fcs.0", spec)
    C = lifted.shape[1]
    grid = spec.grid
    acc = torch.zeros((grid.cells, C + 11), dtype=torch.float32, device=pos.device)
    for c0 in range(0, pos.shape[0], spec.chunk):
        node, slot = valid[c0:c0 + spec.chunk].nonzero(as_tuple=True)
        node = node + c0
        cell = cells[node, slot]
        pt, cp = pos[node], grid.cell_pos(cell)
        vals = kernel_mlp(torch.cat([pt, cp], dim=-1), W, "encoder.gno.channel_mlp.fcs",
                          spec.enc_layers, spec) * lifted[node]
        acc = acc.index_add(0, cell, torch.cat([vals, _moments(pt - cp)], dim=-1))
    moments = acc[:, C:].detach()
    gno = acc[:, :C] / moments[:, :1].clamp_min(1.0)
    z = _znorm(_cell_features(moments))
    geo = dense(F.relu(dense(z, W, "encoder.geoembed.mlp.0", spec)), W,
                "encoder.geoembed.mlp.2", spec)
    return gno, geo


def recover(W: Weights, spec: Spec, gno: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
    """The encoder's output, latent [M, C], from its two halves."""
    return dense(torch.cat([gno, geo], dim=-1), W, "encoder.recovery.fcs.0", spec)


# -- processor ---------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor) -> torch.Tensor:
    """Sequence-order rotary of [..., S, D] (interleaved pairs, theta 10000)."""
    S, D = x.shape[-2], x.shape[-1]
    freqs = 1.0 / (10000.0 ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    pairs = x.reshape(*x.shape[:-1], D // 2, 2)
    x0, x1 = pairs[..., 0], pairs[..., 1]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(x.shape)


def _keep_scale(rate: float, device) -> torch.Tensor:
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device)


class BlockedAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(D)) v over [1, H, S, D] in blocks of query rows:
    q prescaled in f32 and rounded to its type, logits and softmax in f32, the
    denominator summed before dropout, kept probabilities times 1/(1-rate)
    and rounded to v's type for the product with v, the output rounded once.
    The backward recomputes each block from the log-sum-exp and regenerates
    its keep mask; dq, dk, dv are summed in f32 and rounded once."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate, rows, fp8=False):
        H, S, D = q.shape[1:]
        scale = 1.0 / D ** 0.5
        qs = (q.float() * scale).to(q.dtype).float()[0]
        kf, vf = k.float()[0], v.float()[0]
        out = torch.empty_like(q)
        lse = torch.empty((H, S), dtype=torch.float32, device=q.device)
        for r0 in range(0, S, rows):
            r1 = min(r0 + rows, S)
            s = qs[:, r0:r1] @ kf.transpose(-1, -2)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
            if rate > 0.0:
                keep = keep_rows(seed, rate, H, r0, r1, S, q.device)
                p = p * (keep.to(torch.float32) * _keep_scale(rate, q.device))
            pv = (round_fp8(p) if fp8 else p.to(v.dtype).float()) @ vf
            out[0, :, r0:r1] = (pv / l).to(q.dtype)
            lse[:, r0:r1] = (m + torch.log(l))[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (seed, rate, rows)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        seed, rate, rows = ctx.static
        H, S, D = q.shape[1:]
        scale = 1.0 / D ** 0.5
        qs = (q.float() * scale).to(q.dtype).float()[0]
        kf, vf = k.float()[0], v.float()[0]
        dof = dout.to(q.dtype).float()[0]
        delta = (dof * out.float()[0]).sum(dim=-1)
        dq = torch.empty((H, S, D), dtype=torch.float32, device=q.device)
        dk = torch.zeros((H, S, D), dtype=torch.float32, device=q.device)
        dv = torch.zeros((H, S, D), dtype=torch.float32, device=q.device)
        for r0 in range(0, S, rows):
            r1 = min(r0 + rows, S)
            p = torch.exp(qs[:, r0:r1] @ kf.transpose(-1, -2) - lse[:, r0:r1, None])
            dpv = dof[:, r0:r1] @ vf.transpose(-1, -2)
            pm = p
            if rate > 0.0:
                km = keep_rows(seed, rate, H, r0, r1, S, q.device).to(torch.float32) \
                    * _keep_scale(rate, q.device)
                pm = p * km
                dpv = dpv * km
            ds = p * (dpv - delta[:, r0:r1, None])
            dv += pm.to(dout.dtype).float().transpose(-1, -2) @ dof[:, r0:r1]
            dsr = ds.to(q.dtype).float()
            dk += dsr.transpose(-1, -2) @ qs[:, r0:r1]
            dq[:, r0:r1] = (dsr @ kf) * scale
        return (dq[None].to(q.dtype), dk[None].to(k.dtype), dv[None].to(v.dtype),
                None, None, None, None)


def attention(x: torch.Tensor, W: Weights, pre: str, spec: Spec, seed: Optional[int],
              rate: float) -> torch.Tensor:
    B, S, Hd = x.shape
    H = spec.heads

    def heads(name):
        return dense(x, W, f"{pre}.{name}", spec).reshape(B, S, H, Hd // H).transpose(1, 2)

    q, k, v = rope(heads("q_proj")), rope(heads("k_proj")), heads("v_proj")
    fp8 = spec.attention_bf16 and spec.control == "fp8"
    if fp8:
        q, k, v = (round_fp8(t).to(torch.bfloat16) for t in (q, k, v))
    elif spec.attention_bf16:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = BlockedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), seed, rate,
                                 spec.attn_rows, fp8)
    return dense(out.transpose(1, 2).reshape(B, S, Hd).to(x.dtype), W, f"{pre}.o_proj", spec)


def block(x, W: Weights, pre: str, spec: Spec, seed, rate, skip=None):
    if skip is not None:
        x = dense(torch.cat([x, skip], dim=-1), W, f"{pre}.skip_proj", spec)
    h = x + attention(rmsnorm(x, W[f"{pre}.attn_norm.weight"], spec.norm_eps), W,
                      f"{pre}.attn", spec, seed, rate)
    h = rmsnorm(h, W[f"{pre}.ffn_norm.weight"], spec.norm_eps)
    gate = F.silu(dense(h, W, f"{pre}.ffn.w1", spec)) * dense(h, W, f"{pre}.ffn.w3", spec)
    return h + dense(gate, W, f"{pre}.ffn.w2", spec)


def process(W: Weights, spec: Spec, latent: torch.Tensor,
            seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Latent [M, C] -> [M, C]; `seeds` (one a block, in block order) turn
    on attention dropout."""
    D, H, Wd = spec.grid.dims
    P = spec.patch
    C = latent.shape[-1]
    nd, nh, nw = D // P, H // P, Wd // P
    x = latent.reshape(1, nd, P, nh, P, nw, P, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    x = dense(x.reshape(1, nd * nh * nw, P * P * P * C), W, "patch_linear", spec)
    rate = spec.dropout if seeds is not None else 0.0
    seeds = list(seeds) if seeds is not None else [None] * spec.layers
    half = spec.layers // 2
    skips = []
    for i in range(half):
        x = block(x, W, f"processor.encoder_layers.{i}", spec, seeds[i], rate)
        skips.append(x)
    for i in range(half):
        x = block(x, W, f"processor.decoder_layers.{i}", spec, seeds[half + i], rate,
                  skip=skips.pop())
    x = x.reshape(1, nd, nh, nw, P, P, P, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(D * H * Wd, C)


# -- decoder -----------------------------------------------------------------


def decode(W: Weights, spec: Spec, latent, pos, cells, valid) -> torch.Tensor:
    """Latent [M, C] -> predictions [N, C_out] at the points."""
    grid = spec.grid
    outs = []
    for c0 in range(0, pos.shape[0], spec.chunk):
        v = valid[c0:c0 + spec.chunk]
        node, slot = v.nonzero(as_tuple=True)
        cell = cells[c0:c0 + spec.chunk][node, slot]
        cp, pt = grid.cell_pos(cell), pos[c0 + node]
        vals = kernel_mlp(torch.cat([cp, pt], dim=-1), W, "decoder.gno.channel_mlp.fcs",
                          spec.dec_layers, spec) * latent[cell]
        total = torch.zeros((v.shape[0], vals.shape[1]), dtype=vals.dtype, device=vals.device)
        total = total.index_add(0, node, vals)
        g = total / v.sum(dim=1, keepdim=True).clamp_min(1).to(vals.dtype)
        outs.append(dense(F.gelu(dense(g, W, "decoder.projection.fcs.0", spec)), W,
                          "decoder.projection.fcs.1", spec))
    return torch.cat(outs, dim=0)


def forward(W: Weights, spec: Spec, pos, feats, cells, valid,
            seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    return forward_parts(W, spec, pos, feats, cells, valid, seeds)["pred"]


def forward_parts(W: Weights, spec: Spec, pos, feats, cells, valid,
                  seeds: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """The forward's stages: the GNO mean "gno" and statistical geoembed
    "geo" (encode_parts), the encoder's output "enc", the processor's output
    "dec_in" and the prediction "pred"."""
    gno, geo = encode_parts(W, spec, pos, feats, cells, valid)
    enc = recover(W, spec, gno, geo)
    dec_in = process(W, spec, enc, seeds)
    return {"gno": gno, "geo": geo, "enc": enc, "dec_in": dec_in,
            "pred": decode(W, spec, dec_in, pos, cells, valid)}


def masked_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every node (all nodes of a mesh are valid)."""
    diff = pred - target
    return (diff * diff).sum() / diff.numel()


def layer_seeds(generator: torch.Generator, layers: int) -> List[int]:
    """The dropout seeds of one training forward: `layers` draws of
    randint(0, 2^63 - 1) from the step's generator."""
    draws = torch.randint(0, 2 ** 63 - 1, (layers,), dtype=torch.int64, generator=generator,
                          device=generator.device)
    return [int(s) for s in draws.tolist()]

