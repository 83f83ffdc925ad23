"""The port at `kernel_dtype: bfloat16` against the JAX package on CPU.

The same numpy inputs and weights go through the JAX function at bf16 and at
f32 and through its counterpart in the port at bf16: the kernel MLP
(`kernel_mlp_apply`) and its gradient, the fused encoder over degree
sections (the plain versions of K5 and K5b), the decoder's GNO chunk, the
whole GAOT3D forward and one train-step gradient, the served model, and the
trainer's `setup.dtype` rule. Every comparison is relative L2 against JAX
bf16, held to a tenth of JAX bf16's own relative L2 from JAX f32 on the same
inputs (`assert_bf16_grade`), so a bf16 path that quietly ran f32 fails. The
two sides then differ only by f32 sums taken in another order, which now and
then flip a bf16 rounding. A quantity that does not depend on the kernel
dtype at all (the last layer's db of a lone MLP) is held to 1e-6 instead.

One exception: the kernel MLPs' weight gradients dW. Both sides round a
chunk's dW to bf16 after an f32 sum, XLA's CPU dot and torch's gemm each in
an order of its own. Over the lone MLP's 4,096 rows the two sums differ by
about 1e-4 of an entry, and in the model's short chunks the first layer's
entries (positions times a cotangent) are near-cancelling sums whose last
f32 bits differ as much. Either way some entries land on the other side of a
bf16 rounding (1-8% of them, a bf16 step of that chunk's part each), which
measured 0.02 to 0.15 of JAX bf16's gap from f32 in L2 over the seeds tried
(0.11 for the model's first encoder layer). So dW is held to a quarter of
the gap (`DW_GAP_SHARE`); an f32 path would sit at the whole gap.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.models.fused_decoder import FusedDecoderScale as JaxFusedDecoderScale
from gaot3d_tpu.models.fused_encoder import FusedEncoderScale as JaxFusedEncoderScale
from gaot3d_tpu.models.mlp import kernel_mlp_apply as jax_kernel_mlp_apply
from gaot3d_tpu.ops import grid_graph as jgg
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu.train.trainer import masked_mse as jax_masked_mse
from gaot3d_tpu_torch.kernels import encoder_payload as k5
from gaot3d_tpu_torch.models import init_model
from gaot3d_tpu_torch.models.fused_encoder import FusedEncoderScale, StatisticalGeoEmbedding
from gaot3d_tpu_torch.models.integral_transform import IntegralTransform
from gaot3d_tpu_torch.models.mlp import ChannelMLP, kernel_mlp_apply
from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots, LatentGrid
from gaot3d_tpu_torch.serve import export_inference, load_inference
from gaot3d_tpu_torch.train import masked_mse
from gaot3d_tpu_torch.weights import load_numpy_state_dict, numpy_state_dict
from test_degree_sections import _flagship_model, _problem
from test_torch_port_model import _port_configs, _sections, _with_attention_dtype
from test_torch_port_trainer import port_trainer, small_config
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPE_FREE_LIMIT = 1e-6  # a value both JAX dtypes give alike: f32 sums in another order
DW_GAP_SHARE = 0.25  # the kernel MLPs' dW (see above)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_bf16_grade(name, port, jax_bf16, jax_f32):
    """`port` within a tenth of JAX bf16's distance from JAX f32, of JAX bf16,
    in relative L2; a kernel MLP's dW (named dW<i> or ...channel_mlp...weight)
    within DW_GAP_SHARE of it."""
    gap, err = rel_l2(jax_bf16, jax_f32), rel_l2(port, jax_bf16)
    is_dw = name.startswith("dW") or ("channel_mlp" in name and name.endswith("weight"))
    share = DW_GAP_SHARE if is_dw else 0.1
    limit = share * gap if gap > 0 else DTYPE_FREE_LIMIT
    assert err <= limit, (f"{name}: {err:.3e} from JAX bf16, which is {gap:.3e} from JAX f32 "
                          f"(limit {limit:.3e})")


def _uniform_weights(rng, widths):
    """torch.nn.Linear-style weights in the JAX layout ([in, out]) and biases."""
    ws, bs = [], []
    for i, o in zip(widths[:-1], widths[1:]):
        bound = i ** -0.5
        ws.append(rng.uniform(-bound, bound, (i, o)).astype(np.float32))
        bs.append(rng.uniform(-bound, bound, o).astype(np.float32))
    return ws, bs


def _linear_layers(widths, ws, bs):
    """The port's ChannelMLP holding JAX-layout weights, with gradients."""
    mlp = ChannelMLP(list(widths))
    with torch.no_grad():
        for fc, w, b in zip(mlp.fcs, ws, bs):
            fc.weight.copy_(torch.from_numpy(w.T.copy()))
            fc.bias.copy_(torch.from_numpy(b))
    return mlp


@pytest.mark.parametrize("widths", [(6, 64, 64, 64, 32), (6, 64, 64, 32)],
                         ids=["encoder-6-64-64-64-32", "decoder-6-64-64-32"])
def test_kernel_mlp_and_its_gradient_match_jax_bf16(widths):
    rng = np.random.default_rng(len(widths))
    x = rng.uniform(-1, 1, (4096, 6)).astype(np.float32)
    ws, bs = _uniform_weights(rng, widths)
    cot = rng.normal(size=(4096, widths[-1])).astype(np.float32)

    def jax_run(dtype):
        def loss(x_, ws_, bs_):
            out = jax_kernel_mlp_apply(x_, ws_, bs_, dtype)
            return jnp.sum(out * cot), out
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
        dx, dws, dbs = grads
        return [np.asarray(out), np.asarray(dx)] + [np.asarray(w) for w in dws] + \
            [np.asarray(b) for b in dbs]

    want, f32 = jax_run("bfloat16"), jax_run("float32")
    mlp = _linear_layers(widths, ws, bs)
    xt = torch.from_numpy(x).requires_grad_()
    out = kernel_mlp_apply(xt, mlp.fcs, "bfloat16")
    (out * torch.from_numpy(cot)).sum().backward()
    got = [out.detach().numpy(), xt.grad.numpy()] + \
        [fc.weight.grad.numpy().T for fc in mlp.fcs] + [fc.bias.grad.numpy() for fc in mlp.fcs]
    n = len(ws)
    names = ["out", "dx"] + [f"dW{i}" for i in range(n)] + [f"db{i}" for i in range(n)]
    for name, a, b, c in zip(names, got, want, f32):
        assert_bf16_grade(name, a, b, c)


def _encoder_problem(N=256, C=8, chunk=8, seed=3):
    """Degree sections of a 2 x N cloud on the 4x4x4 grid (each section a
    multiple of 16 nodes, so `chunk` gives every section several chunks),
    lifted features and a cotangent of the accumulator."""
    pos, _, _, mask, lat_c, msk_c = _problem(seed=seed, N=N)
    perms, jsect, psect = _sections(lat_c, msk_c)
    assert len(psect.sections) > 1
    rows = np.arange(pos.shape[0])[:, None]
    pos = pos[rows, perms]
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, N, C)).astype(np.float32)
    g = rng.normal(size=(2, 64, C + 11)).astype(np.float32)
    return pos, feats, g, jsect, psect


def _jax_encoder(dtype, C, chunk):
    return JaxFusedEncoderScale(lifting_channels=C, kernel_layers=(6, 16, 16, C),
                                transform_type="linear", grid=jgg.LatentGrid(dims=(4, 4, 4)),
                                edge_chunk_size=chunk, kernel_dtype=dtype)


def _jax_sections_vjp(dtype, params, pos, feats, g, jsect, C, chunk):
    """JAX's accumulator threaded through the sections, and its vjp with
    respect to the features and the kernel MLP at cotangent g."""
    jmod = _jax_encoder(dtype, C, chunk)

    def run(kernel, feats_):
        p = {"params": {**params["params"], **kernel}}
        acc, off = jnp.zeros((2, 64, C + 11)), 0
        for sec in jsect.sections:
            ns = int(sec.lat_idx.shape[-2])
            acc = jmod.apply(p, sec, jnp.asarray(pos[:, off:off + ns]), feats_[:, off:off + ns],
                             64, acc0=acc, method=JaxFusedEncoderScale._run_slotted)
            off += ns
        return acc

    kernel = {k: v for k, v in params["params"].items() if k.startswith("kernel_")}
    acc, vjp = jax.vjp(run, kernel, jnp.asarray(feats))
    dk, dfeats = vjp(jnp.asarray(g))
    n = len(kernel) // 2
    return ([np.asarray(acc)[..., :C], np.asarray(dfeats)]
            + [np.asarray(dk[f"kernel_w{i}"]) for i in range(n)]
            + [np.asarray(dk[f"kernel_b{i}"]) for i in range(n)])


def _port_sections_grad(params, pos, feats, g, psect, C, chunk):
    """The port's FusedEncoderScale (K5 / K5b plain versions) over the same
    sections, and the same gradients through autograd."""
    p = params["params"]
    grid = LatentGrid(dims=(4, 4, 4))
    gno = IntegralTransform([6, 16, 16, C], grid, kernel_dtype="bfloat16")
    with torch.no_grad():
        for i, fc in enumerate(gno.channel_mlp.fcs):
            fc.weight.copy_(torch.from_numpy(np.array(p[f"kernel_w{i}"]).T.copy()))
            fc.bias.copy_(torch.from_numpy(np.array(p[f"kernel_b{i}"])))
    fused = FusedEncoderScale(gno, StatisticalGeoEmbedding(3, C), grid, C, chunk,
                              kernel_dtype="bfloat16")
    ft = torch.from_numpy(feats).requires_grad_()
    pt = torch.from_numpy(pos)
    acc, off = torch.zeros((2, 64, C + 11)), 0
    for sec in psect.sections:
        ns = int(sec.lat_idx.shape[-2])
        acc = fused._run_slotted(sec, pt[:, off:off + ns], ft[:, off:off + ns], acc)
        off += ns
    fcs = gno.channel_mlp.fcs
    grads = torch.autograd.grad(acc, [ft] + [fc.weight for fc in fcs] + [fc.bias for fc in fcs],
                                torch.from_numpy(g))
    n = len(fcs)
    return ([acc.detach().numpy()[..., :C], grads[0].numpy()]
            + [w.numpy().T for w in grads[1:1 + n]] + [b.numpy() for b in grads[1 + n:]])


def test_fused_encoder_over_sections_matches_jax_bf16():
    """The accumulator's value columns, dfeats, dW and db of the encoder's
    kernel MLP over degree sections of chunks of 8 nodes."""
    C, chunk = 8, 8
    pos, feats, g, jsect, psect = _encoder_problem(C=C, chunk=chunk)
    sec0 = jsect.sections[0]
    ns0 = int(sec0.lat_idx.shape[-2])
    params = _jax_encoder("bfloat16", C, chunk).init(
        jax.random.key(0), sec0, jnp.asarray(pos[:, :ns0]), jnp.asarray(feats[:, :ns0]), 64,
        method=JaxFusedEncoderScale._run_slotted)
    want = _jax_sections_vjp("bfloat16", params, pos, feats, g, jsect, C, chunk)
    f32 = _jax_sections_vjp("float32", params, pos, feats, g, jsect, C, chunk)
    got = _port_sections_grad(params, pos, feats, g, psect, C, chunk)
    names = ["acc values", "dfeats", "dW0", "dW1", "dW2", "db0", "db1", "db2"]
    for name, a, b, c in zip(names, got, want, f32):
        assert_bf16_grade(name, a, b, c)


def test_plain_backward_rounds_dw_once_a_chunk():
    """Under bf16 the plain backward's dW is a sum of bf16 values, one per
    node chunk, and db is not rounded; the sum over three chunks is not the
    single rounding of their sum, and JAX's grad at the same chunks agrees
    with the chunked sum far better than with the single rounding."""
    C, n, K = 8, 96, 3
    rng = np.random.default_rng(8)
    grid = LatentGrid(dims=(4, 4, 4))
    pos = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    feats = rng.normal(size=(1, n, C)).astype(np.float32)
    lat = rng.integers(0, 64, (1, n, K)).astype(np.int32)
    msk = rng.random((1, n, K)) < 0.8
    g = rng.normal(size=(1, 64, C + 11)).astype(np.float32)
    jws, jbs = _uniform_weights(rng, (6, 16, 16, C))
    t = torch.from_numpy
    ws, bs = [t(w.T.copy()) for w in jws], [t(b) for b in jbs]

    def backward(c0, c1, chunk):
        return k5.encoder_accumulate_backward_reference(
            t(g), t(pos[:, c0:c1]), t(feats[:, c0:c1]), t(lat[:, c0:c1]), t(msk[:, c0:c1]),
            ws, bs, grid, chunk, "bfloat16")

    parts = [backward(c0, c0 + 32, None) for c0 in (0, 32, 64)]
    for _, dws, dbs in parts:
        for dw in dws:
            assert torch.equal(k5.round_bf16(dw), dw)
        assert not all(torch.equal(k5.round_bf16(db), db) for db in dbs)
    chunked = backward(0, n, 32)
    for i, dw in enumerate(chunked[1]):
        assert torch.equal(dw, torch.zeros_like(dw) + parts[0][1][i] + parts[1][1][i]
                           + parts[2][1][i])
    once = backward(0, n, None)
    assert all(torch.equal(k5.round_bf16(dw), dw) for dw in once[1])

    jmod = JaxFusedEncoderScale(lifting_channels=C, kernel_layers=(6, 16, 16, C),
                                transform_type="linear", grid=jgg.LatentGrid(dims=(4, 4, 4)),
                                edge_chunk_size=32, kernel_dtype="bfloat16")
    slots = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    kernel = {**{f"kernel_w{i}": jnp.asarray(w) for i, w in enumerate(jws)},
              **{f"kernel_b{i}": jnp.asarray(b) for i, b in enumerate(jbs)}}
    params = jmod.init(jax.random.key(0), slots, jnp.asarray(pos), jnp.asarray(feats), 64,
                       method=JaxFusedEncoderScale._run_slotted)
    run = lambda k: jmod.apply({"params": {**params["params"], **k}}, slots,  # noqa: E731
                               jnp.asarray(pos), jnp.asarray(feats), 64,
                               method=JaxFusedEncoderScale._run_slotted)
    _, vjp = jax.vjp(run, kernel)
    (dk,) = vjp(jnp.asarray(g))
    for i in range(3):
        want = np.asarray(dk[f"kernel_w{i}"]).T
        err_chunked = rel_l2(chunked[1][i].numpy(), want)
        err_once = rel_l2(once[1][i].numpy(), want)
        assert err_once > 1e-4 and err_chunked <= 0.1 * err_once, (i, err_chunked, err_once)


def test_decoder_chunk_matches_jax_bf16():
    """The decoder's GNO chunk (kernel MLP 6-16-8 on [cell | point], the
    mean over each point's valid slots) and its gradients with respect to
    the latent features and the kernel MLP."""
    C, B, n, K, M = 8, 2, 128, 5, 64
    rng = np.random.default_rng(12)
    latent = rng.normal(size=(B, M, C)).astype(np.float32)
    pos = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    lat = rng.integers(0, M, (B, n, K)).astype(np.int32)
    msk = rng.random((B, n, K)) < 0.7
    cot = rng.normal(size=(B, n, C)).astype(np.float32)

    def jax_run(dtype, params=None):
        jmod = JaxFusedDecoderScale(channels=C, kernel_layers=(6, 16, C), transform_type="linear",
                                    grid=jgg.LatentGrid(dims=(4, 4, 4)), kernel_dtype=dtype)
        args = (jnp.asarray(latent), jnp.asarray(pos), jnp.asarray(lat), jnp.asarray(msk))
        if params is None:
            params = jmod.init(jax.random.key(1), *args, method=JaxFusedDecoderScale._gno_chunk)

        def loss(p, lf):
            out = jmod.apply(p, lf, *args[1:], method=JaxFusedDecoderScale._gno_chunk)
            return jnp.sum(out * cot), out
        (_, out), (dp, dl) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, args[0])
        d = dp["params"]
        return params, [np.asarray(out), np.asarray(dl)] + \
            [np.asarray(d[f"kernel_w{i}"]) for i in range(2)] + \
            [np.asarray(d[f"kernel_b{i}"]) for i in range(2)]

    params, want = jax_run("bfloat16")
    _, f32 = jax_run("float32", params)
    p = params["params"]
    gno = IntegralTransform([6, 16, C], LatentGrid(dims=(4, 4, 4)), kernel_dtype="bfloat16")
    with torch.no_grad():
        for i, fc in enumerate(gno.channel_mlp.fcs):
            fc.weight.copy_(torch.from_numpy(np.array(p[f"kernel_w{i}"]).T.copy()))
            fc.bias.copy_(torch.from_numpy(np.array(p[f"kernel_b{i}"])))
    lt = torch.from_numpy(latent).requires_grad_()
    out = gno.decoder_chunk(lt, torch.from_numpy(pos), torch.from_numpy(lat),
                            torch.from_numpy(msk))
    (out * torch.from_numpy(cot)).sum().backward()
    fcs = gno.channel_mlp.fcs
    got = [out.detach().numpy(), lt.grad.numpy()] + [fc.weight.grad.numpy().T for fc in fcs] + \
        [fc.bias.grad.numpy() for fc in fcs]
    for name, a, b, c in zip(["out", "dlatent", "dW0", "dW1", "db0", "db1"], got, want, f32):
        assert_bf16_grade(name, a, b, c)


def _bf16_pair(seed):
    """(JAX model at bf16, the same at f32, params, port model at bf16) on
    the flagship test model with f32 attention and dropout 0."""
    jbf = _with_attention_dtype(_flagship_model(kernel_dtype="bfloat16"), "float32")
    jf32 = _with_attention_dtype(_flagship_model(kernel_dtype="float32"), "float32")
    pos, feats, _, mask, lat_c, msk_c = _problem()
    base = jgg.EdgeSlots(lat_idx=jnp.asarray(lat_c), mask=jnp.asarray(msk_c))
    params = jbf.init({"params": jax.random.key(seed)}, jnp.asarray(pos), jnp.asarray(feats),
                      jnp.asarray(mask), encoder_slots=[base], decoder_slots=[base])
    magno, attn = _port_configs(jbf)
    assert magno.kernel_dtype == "bfloat16"
    sd = state_dict_from_params(params, jbf.magno_config, jbf.attn_config,
                                latent_tokens=jbf.latent_tokens)
    pmodel = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=jbf.latent_tokens,
                        device="cpu")
    load_numpy_state_dict(pmodel, sd)
    return jbf, jf32, params, pmodel


def test_whole_model_forward_and_train_gradient_match_jax_bf16():
    """GAOT3D on degree sections (edge chunks of 16 nodes): the train-mode
    prediction, the masked-MSE loss and every gradient leaf."""
    jbf, jf32, params, pmodel = _bf16_pair(seed=4)
    pos, feats, target, mask, lat_c, msk_c = _problem(seed=71)
    perms, jsect, psect = _sections(lat_c, msk_c)
    rows = np.arange(pos.shape[0])[:, None]
    pos, feats, target, mask = (x[rows, perms] for x in (pos, feats, target, mask))

    def jax_run(jmodel):
        def loss(p):
            pred = jmodel.apply(p, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                                train=True, encoder_slots=[jsect], decoder_slots=[jsect])
            return jax_masked_mse(pred, jnp.asarray(target), jnp.asarray(mask)), pred
        (value, pred), grads = jax.value_and_grad(loss, has_aux=True)(params)
        tree = state_dict_from_params(grads, jmodel.magno_config, jmodel.attn_config)
        return float(value), np.asarray(pred), {k: np.asarray(v) for k, v in tree.items()}

    want_loss, want_pred, want = jax_run(jbf)
    f32_loss, f32_pred, f32 = jax_run(jf32)
    pmodel.train()
    t = torch.from_numpy
    pred = pmodel(t(pos), t(feats), t(mask), encoder_slots=[psect], decoder_slots=[psect])
    loss = masked_mse(pred, t(target), t(mask))
    loss.backward()
    assert_bf16_grade("prediction", pred.detach().numpy(), want_pred, f32_pred)
    assert_bf16_grade("loss", [loss.item()], [want_loss], [f32_loss])
    got = numpy_state_dict(pmodel, grads=True)
    assert set(got) == set(want)
    for key in sorted(got):
        assert np.isfinite(got[key]).all(), key
        assert_bf16_grade(key, got[key], want[key], f32[key])


@pytest.mark.parametrize("edges", ["args", "device"])
def test_served_model_runs_bf16_as_exported(tmp_path, edges):
    """A bf16 model exported and loaded again serves at bf16: its artifact
    carries kernel_dtype, and the served prediction matches JAX's bf16 eval
    forward (the slots passed in, or built by the model from the points)."""
    jbf, jf32, params, pmodel = _bf16_pair(seed=5)
    pos, feats, _, mask, lat_c, msk_c = _problem(seed=73)
    path = os.path.join(str(tmp_path), "bf16.pt")
    export_inference(pmodel, path)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert blob["config"]["magno_config"]["kernel_dtype"] == "bfloat16"
    infer = load_inference(path, device="cpu", edges=edges)
    slots = jgg.EdgeSlots(jnp.asarray(lat_c), jnp.asarray(msk_c))
    t = torch.from_numpy
    if edges == "args":
        ps = EdgeSlots.from_numpy(lat_c, msk_c)
        got = infer(t(pos), t(feats), t(mask), ps, ps).numpy()
        kw = dict(encoder_slots=[slots], decoder_slots=[slots])
    else:
        got = infer(t(pos), t(feats), t(mask)).numpy()
        kw = {}
    want, f32 = (np.asarray(m.apply(params, jnp.asarray(pos), jnp.asarray(feats),
                                    jnp.asarray(mask), **kw)) for m in (jbf, jf32))
    assert_bf16_grade("served prediction", got, want, f32)


@pytest.mark.parametrize("setup_dtype,kernel_dtype,want", [
    ("bfloat16", "float32", "bfloat16"),
    ("float32", "bfloat16", "bfloat16"),
    ("bfloat16", "bfloat16", "bfloat16"),
    ("float32", "float32", "float32"),
])
def test_trainer_applies_the_setup_dtype_rule(tmp_path, setup_dtype, kernel_dtype, want):
    """setup.dtype bfloat16 turns a float32 kernel_dtype into bfloat16 and
    leaves an explicit one alone (gaot3d_tpu/train/trainer.py); the model's
    both GNO kernel MLPs then run at that dtype, and the parameters stay
    f32."""
    cfg = small_config(tmp_path)
    cfg["setup"]["dtype"] = setup_dtype
    cfg["model"]["args"]["magno"]["kernel_dtype"] = kernel_dtype
    trainer = port_trainer(cfg, tmp_path)
    model = trainer.model
    assert model.magno_config.kernel_dtype == want
    assert model.encoder.fused.kernel_dtype == want
    assert model.decoder.gno.kernel_dtype == want
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_unknown_kernel_dtype_is_refused():
    magno, attn = _port_configs(_flagship_model())
    with pytest.raises(ValueError, match="kernel_dtype"):
        init_model(2, 1, "gaot_3d", dataclasses.replace(magno, kernel_dtype="float16"), attn,
                   latent_tokens=(4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="kernel_dtype"):
        k5.kernel_mlp(torch.zeros(2, 6), [torch.zeros(4, 6)], [torch.zeros(4)], "float16")


def test_packed_weight_entries_follow_the_packing():
    """`_weight_entries` (the spans the bf16 backward rounds) cover exactly
    the weights of `_pack_mlp`'s layout and none of its biases."""
    shapes = [(16, 6), (16, 16), (8, 16)]
    ws = [torch.full(s, 1.0) for s in shapes]
    bs = [torch.full((s[0],), 2.0) for s in shapes]
    packed = k5._pack_mlp(ws, bs)
    is_w = torch.zeros_like(packed, dtype=torch.bool)
    for a, b in k5._weight_entries(shapes):
        is_w[a:b] = True
    assert torch.equal(is_w, packed == 1.0)
