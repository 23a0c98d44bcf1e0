"""The port's models (unidefense_torch/models, inference) against the JAX
package on the CPU in fp32, weights bridged by ``state_dict_from_jax``.

Every ``sf_coef`` is set to 0 before conversion: the init value of -10
weights the frequency branch by 4.5e-5 and would hide any error in it.
BatchNorm running statistics are randomised so eval-mode BN is not the
identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from unidefense_torch.data.transforms import DevicePipeline as TorchDevicePipeline
from unidefense_torch.inference import Predictor, resize_frames
from unidefense_torch.models import efficientnet as teff
from unidefense_torch.models import filters as tfilt
from unidefense_torch.models import layers as tl
from unidefense_torch.models.convert import state_dict_from_jax
from unidefense_torch.models.registry import build_model
from unidefense_torch.models.unidefense import DecoderBlock as TorchDecoderBlock
from unidefense_torch.models.unidefense import UniDefenseModelEb4 as TorchUDEB4
from unidefense_tpu.data.transforms import DevicePipeline
from unidefense_tpu.models import efficientnet as jeff
from unidefense_tpu.models import filters as jfilt
from unidefense_tpu.models import layers as jl
from unidefense_tpu.models.convert import export_torch_state_dict
from unidefense_tpu.models.unidefense import DecoderBlock as JaxDecoderBlock
from unidefense_tpu.models.unidefense import UniDefenseModelEb4 as JaxUDEB4
from unidefense_tpu.train.step import make_eval_step

B0_DELIMITER = [1, 3, 5, 8, 11, 15, 16]
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomise(variables, seed=0, classifier_std=None):
    """sf_coef -> 0, random BN running stats (and optionally a wider
    classifier so probabilities spread), as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for coll, tree in variables.items():
        flat = flatten_dict(jax.tree.map(np.asarray, tree))
        for path, v in flat.items():
            if path[-1] == "sf_coef":
                v = np.zeros((), np.float32)
            elif path[-1] == "mean":
                v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif path[-1] == "var":
                v = (0.75 + 0.5 * rng.random(v.shape)).astype(np.float32)
            elif classifier_std and "classifier" in path and path[-1] == "kernel":
                v = (classifier_std * rng.standard_normal(v.shape)).astype(np.float32)
            flat[path] = np.array(v)
        out[coll] = unflatten_dict(flat)
    return out


def _bridge(variables, prefix, strip=""):
    """Place a layer's JAX variables under `prefix` of the UDEB4 tree,
    convert, and strip `strip` from the torch keys."""
    tree = {}
    for coll, sub in variables.items():
        node = sub
        for p in reversed(prefix):
            node = {p: node}
        tree[coll] = node
    return {k[len(strip):]: v for k, v in state_dict_from_jax(tree).items()}


def _init(module, *args, **kw):
    v = module.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                    *args, **kw)
    return _randomise(v)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("k,s,pad,groups", [
    (3, 1, "SAME", 1), (3, 2, "SAME", 1), (5, 2, "SAME", 1), (5, 2, "SAME", 4), (3, 1, 1, 1),
])
def test_conv_matches_jax(k, s, pad, groups):
    x = _x((2, 11, 10, 4))
    feat = 4 if groups > 1 else 6
    jm = jl.Conv(feat, k, s, pad, groups=groups, use_bias=True)
    v = _init(jm, jnp.asarray(x))
    v["params"]["Conv_0"]["bias"] = _x((feat,), 1)
    tm = tl.Conv(4, feat, k, s, pad, groups=groups, bias=True)
    tm.load_state_dict(_bridge(v, ("backbone", "block0", "expand_conv"),
                               "backbone._blocks.0._expand_conv."), strict=True)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("ndim", [2, 4])
def test_batchnorm_eval_matches_jax(ndim):
    x = _x((3, 5) if ndim == 2 else (3, 6, 7, 5))
    jm = jl.BatchNorm(epsilon=1e-3)
    v = _init(jm, jnp.asarray(x), use_running_average=True)
    tm = tl.BatchNorm(5, eps=1e-3).eval()
    tm.load_state_dict(_bridge(v, ("backbone", "bn0"), "backbone._bn0."), strict=True)
    xt = torch.from_numpy(x) if ndim == 2 else _nchw(x)
    got = tm(xt).detach().numpy() if ndim == 2 else _nhwc(tm(xt))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x), use_running_average=True)),
                               **TOL)


def test_frozen_bias_batchnorm_has_untrained_zero_bias():
    v = _init(jl.BatchNorm(frozen_bias=True), jnp.zeros((2, 5)), use_running_average=True)
    sd = _bridge(v, ("bottleneck",), "bottleneck.")
    tm = tl.BatchNorm(5, frozen_bias=True)
    tm.load_state_dict(sd, strict=True)
    assert not tm.bias.requires_grad and float(tm.bias.abs().sum()) == 0.0


def test_instancenorm_and_convtranspose_match_jax():
    x = _x((2, 6, 5, 4))
    jin, jct = jl.InstanceNorm(), jl.ConvTranspose(3, 3, 2, 1, 1)
    vin = _init(jin, jnp.asarray(x))
    vin["params"]["scale"] = _x((4,), 2)
    vin["params"]["bias"] = _x((4,), 3)
    tin = tl.InstanceNorm(4)
    tin.load_state_dict(_bridge(vin, ("dec_block1", "in1"), "dec_block1.1."), strict=True)
    np.testing.assert_allclose(_nhwc(tin(_nchw(x))), np.asarray(jin.apply(vin, jnp.asarray(x))),
                               **TOL)
    vct = _init(jct, jnp.asarray(x))
    tct = tl.ConvTranspose(4, 3, 3, 2, 1, 1)
    tct.load_state_dict(_bridge(vct, ("dec_block1", "deconv"), "dec_block1.3."), strict=True)
    out = tct(_nchw(x))
    assert out.shape == (2, 3, 12, 10)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jct.apply(vct, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("shape,stride", [((2, 10, 10, 6), 1), ((2, 9, 9, 4), 2)])
def test_sfconv_matches_jax(shape, stride):
    x = _x(shape)
    c = shape[-1]
    jm = jl.SFConv(c, 3, stride, "SAME", groups=c)
    v = _init(jm, jnp.asarray(x))
    tm = tl.SFConv(c, 3, stride, "SAME", groups=c)
    tm.load_state_dict(_bridge(v, ("backbone", "block0", "depthwise_conv"),
                               "backbone._blocks.0._depthwise_conv."), strict=True)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("stride,fin", [(2, 8), (1, 16)])
def test_mbconv_block_with_sfconv_matches_jax(stride, fin):
    spec = jeff.BlockSpec(kernel_size=3, stride=stride, expand_ratio=6, input_filters=fin,
                          output_filters=16, se_ratio=0.25, id_skip=True, freq_norm="ortho")
    x = _x((2, 8, 8, fin))
    jm = jeff.MBConvBlock(spec)
    v = _init(jm, jnp.asarray(x), False)
    tm = teff.MBConvBlock(teff.BlockSpec(**spec.__dict__)).eval()
    tm.load_state_dict(_bridge(v, ("backbone", "block0"), "backbone._blocks.0."), strict=True)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm.apply(v, jnp.asarray(x), False)),
                               **TOL)


def test_dynamic_filter_matches_jax():
    x, diff = _x((2, 6, 6, 5)), np.abs(_x((2, 6, 6, 3), 1))
    jm = jfilt.DynamicFilter(kernel_size=3, activation=fnn.silu)
    v = _init(jm, jnp.asarray(x), jnp.asarray(diff), False)
    tm = tfilt.DynamicFilter(5, 3, 3, torch.nn.functional.silu).eval()
    tm.load_state_dict(_bridge(v, ("attention", "spat_filter"), "spat_filter."), strict=True)
    jmask, jout = jm.apply(v, jnp.asarray(x), jnp.asarray(diff), False)
    tmask, tout = tm(_nchw(x), _nchw(diff))
    np.testing.assert_allclose(_nhwc(tmask), np.asarray(jmask), **TOL)
    np.testing.assert_allclose(_nhwc(tout), np.asarray(jout), **TOL)


def test_dual_space_attention_matches_jax():
    pred, img, emb = _x((2, 16, 16, 3)), _x((2, 24, 24, 3), 1), _x((2, 6, 6, 5), 2)
    jm = jfilt.DualSpaceAttention(activation=fnn.silu)
    v = _init(jm, jnp.asarray(pred), jnp.asarray(img), jnp.asarray(emb), False)
    v["params"]["fuse_coef"] = np.asarray(0.3, np.float32)
    tm = tfilt.DualSpaceAttention(5, torch.nn.functional.silu).eval()
    tm.load_state_dict(_bridge(v, ("attention",)), strict=True)
    jout = jm.apply(v, jnp.asarray(pred), jnp.asarray(img), jnp.asarray(emb), False)
    tout = tm(_nchw(pred), _nchw(img), _nchw(emb))
    for key in ("out", "freq_mask", "spat_mask"):
        np.testing.assert_allclose(_nhwc(tout[key]), np.asarray(jout[key]), **TOL)


@pytest.mark.parametrize("final", [False, True])
def test_decoder_block_matches_jax(final):
    x = _x((2, 5, 5, 6))
    jm = JaxDecoderBlock(features=4, final=final, use_swish=True)
    v = _init(jm, jnp.asarray(x))
    tm = TorchDecoderBlock(6, 4, final=final, use_swish=True)
    tm.load_state_dict(_bridge(v, ("dec_block1",), "dec_block1."), strict=True)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("res,expected", [
    (380, [(95, 192, 1), (48, 336, 4), (24, 672, 6), (24, 960, 6), (12, 1632, 7)]),
    (256, [(64, 192, 1), (32, 336, 4), (16, 672, 6), (16, 960, 6), (8, 1632, 7)]),
])
def test_udeb4_sfconv_shape_list(res, expected):
    """(H=W, C, count) of every SFConv frequency-branch input in one UDEB4
    forward, from the port's block specs and TF-SAME stride arithmetic."""
    specs = teff.build_block_specs("efficientnet-b4", "ortho")
    size = -(-res // 2)  # stem stride 2
    seen = []
    for s in specs:
        if s.freq_norm is not None:
            seen.append((size, s.input_filters * s.expand_ratio))
        size = -(-size // s.stride)
    counts = {}
    for key in seen:
        counts[key] = counts.get(key, 0) + 1
    assert [(hw, c, n) for (hw, c), n in counts.items()] == expected
    assert len(seen) == 24


def test_state_dict_bridge_matches_export_and_loads_udeb4():
    """state_dict_from_jax == export_torch_state_dict key for key and value
    for value on the full UDEB4 tree, and loads strictly into the port."""
    shapes = jax.eval_shape(
        lambda: JaxUDEB4().init({"params": jax.random.PRNGKey(0)},
                                jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    variables = {k: dict(v) for k, v in variables.items()}
    ours = state_dict_from_jax(variables)
    ref = export_torch_state_dict(variables)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    TorchUDEB4().load_state_dict(ours, strict=True)


# every key a YAML `model:` section may carry, beside UDEB4's drop_connect_rate
# and delimiter and UDR's mid_depth, which the other models do not take
YAML_KEYS = {"name": "X", "extractor_weights": "ckpt/x.pth", "num_classes": 2, "drop_rate": 0.5,
             "feat_drop_rate": 0.0, "drop_connect_rate": 0.0, "delimiter": B0_DELIMITER,
             "bias": True}


@pytest.mark.parametrize("name,cfg", [
    ("udeb4", {"extractor": "efficientnet-b0"}),
    ("UDR18", {"extractor": "resnet18", "mid_depth": 448}),
    ("UDR50", {"extractor": "resnet50", "mid_depth": 1024}),
    ("UDR101", {}),
])
def test_registry_passes_keys_and_refuses_unported_models(name, cfg):
    """build_model passes each YAML key to the models whose constructor
    takes it and drops the rest (the JAX registry filters by the model's
    fields); a name it does not know raises."""
    cfg = dict(YAML_KEYS, **cfg)
    if name == "UDR101":
        with pytest.raises(KeyError, match="not found"):
            build_model(name, cfg)
        return
    m = build_model(name, cfg)
    assert (m.drop_rate, m.feat_drop_rate) == (0.5, 0.0)
    assert m.classifier.fc.bias is not None and m.freq_filter.layer1[0].bias is not None
    if name == "udeb4":
        assert m.backbone.drop_connect_rate == 0.0 and m.delimiter == B0_DELIMITER
    else:
        with pytest.raises(ValueError, match="mid_depth"):
            build_model(name, dict(cfg, mid_depth=cfg["mid_depth"] + 1))
        with pytest.raises(ValueError, match="extractor"):
            build_model(name, dict(cfg, extractor="efficientnet-b4"))


def test_predictor_matches_jax_eval_step_end_to_end():
    """Port Predictor (CPU) vs JAX make_eval_step(model, DevicePipeline())
    on the b0-scaled UDEB4 at 64², batch 2, same weights: probs, cls_out, rec
    and every loss_dict entry at rtol = atol = 1e-3."""
    jm = JaxUDEB4(extractor="efficientnet-b0", delimiter=B0_DELIMITER, drop_connect_rate=0.0,
                  feat_drop_rate=0.0, dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 64, 64, 3)), train=False)
    v = _randomise(v, classifier_std=0.2)
    # a narrow bottleneck BN spreads the frame-to-frame differences of the
    # head features over the logits, so the probabilities differ per frame
    bn = v["batch_stats"]["bottleneck"]
    bn["mean"], bn["var"] = np.zeros_like(bn["mean"]), np.full_like(bn["var"], 1e-4)
    rng = np.random.default_rng(7)
    ramp = np.broadcast_to(np.linspace(0, 255, 64)[None, :, None], (64, 64, 3))
    frames = np.stack([rng.integers(0, 256, (64, 64, 3)), ramp,
                       rng.integers(0, 64, (64, 64, 3))]).astype(np.uint8)
    tol = dict(rtol=1e-3, atol=1e-3)

    pred = Predictor.from_jax_variables(
        v, "UDEB4", model_cfg={"extractor": "efficientnet-b0", "delimiter": B0_DELIMITER},
        input_size=64, batch_size=2, dtype=torch.float32, device="cpu")

    eval_step = jax.jit(make_eval_step(jm, preprocess=DevicePipeline()))
    jp0, jcls, jrec = eval_step(v["params"], v["batch_stats"], jnp.asarray(frames[:2]), None)
    jp1, _, _ = eval_step(v["params"], v["batch_stats"], jnp.asarray(frames[[2, 2]]), None)
    # three frames: the last batch is padded by repetition
    np.testing.assert_allclose(pred.predict_frames(frames),
                               np.concatenate([np.asarray(jp0), np.asarray(jp1)[:1]]), **tol)
    assert np.ptp(np.asarray(jp0)) > 1e-3  # the probabilities do differ per frame

    jx = DevicePipeline()(jnp.asarray(frames[:2]))
    jout = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(v, jx)
    with torch.inference_mode():
        tx = TorchDevicePipeline()(torch.from_numpy(frames[:2]))
        tout = pred.model(tx.permute(0, 3, 1, 2))
    np.testing.assert_allclose(tout["cls_out"].numpy(), np.asarray(jcls), **tol)
    np.testing.assert_allclose(_nhwc(tout["rec"]), np.asarray(jrec), **tol)
    jl_, tl_ = jout["loss_dict"], tout["loss_dict"]
    assert set(jl_) == set(tl_)
    for key in ("factorization", "spatial", "freq"):
        np.testing.assert_allclose(tl_[key].numpy(), np.asarray(jl_[key]), **tol, err_msg=key)
    for key in ("freq_mask", "spat_mask"):
        np.testing.assert_allclose(_nhwc(tl_[key]), np.asarray(jl_[key]), **tol, err_msg=key)
    assert len(tl_["triplet"]) == len(jl_["triplet"]) == 3
    for t, j in zip(tl_["triplet"], jl_["triplet"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("src", [(300, 300), (720, 720), (200, 333)])
def test_resize_frames_matches_cv2(src):
    """predict_frames resizes other frame sizes with torch (bilinear,
    half-pixel centres, rounded): within 1 intensity level of cv2.resize's
    INTER_LINEAR, up and down. The card machine has no cv2."""
    cv2 = pytest.importorskip("cv2")
    frames = np.random.default_rng(src[1]).integers(0, 256, (2, *src, 3), dtype=np.uint8)
    got = resize_frames(frames, 380)
    ref = np.stack([cv2.resize(f, (380, 380)) for f in frames])
    assert got.dtype == np.uint8 and got.shape == ref.shape == (2, 380, 380, 3)
    assert int(np.abs(got.astype(np.int16) - ref).max()) <= 1
