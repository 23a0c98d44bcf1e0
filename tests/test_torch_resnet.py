"""The port's ResNet modules and UDR18/UDR50 (unidefense_torch/models/resnet.py,
models/unidefense.py) against the JAX package on the CPU in fp32, weights
bridged by ``state_dict_from_jax``.

As in test_torch_models: every ``sf_coef`` is 0 and the BatchNorm running
statistics are random. The BatchNorm scales are random too, here: the last
BatchNorm of each residual block starts at zero and would hide its branch,
SFConvs included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import chip_smoke
from tests.test_torch_models import TOL, _bridge, _init, _nchw, _nhwc, _randomise, _x
from unidefense_torch.inference import Predictor
from unidefense_torch.models import layers as tl
from unidefense_torch.models import resnet as tres
from unidefense_torch.models.convert import state_dict_from_jax
from unidefense_torch.models.registry import build_model
from unidefense_torch.ops.resize import max_pool
from unidefense_tpu.data.transforms import DevicePipeline
from unidefense_tpu.models import layers as jl
from unidefense_tpu.models import resnet as jres
from unidefense_tpu.models.convert import export_torch_state_dict
from unidefense_tpu.models.unidefense import UniDefenseModelRes18, UniDefenseModelRes50
from unidefense_tpu.ops.resize import max_pool as jax_max_pool
from unidefense_tpu.train.step import make_eval_step

JAX_MODELS = {"UDR18": UniDefenseModelRes18, "UDR50": UniDefenseModelRes50}
# where a block's variables sit in the UDR tree, and the torch prefix they get
IN_STAGE = (("extractor", "net", "layer2", "block0"), "extractor.layer2.0.")


def _scaled(variables, seed=1):
    """Every BatchNorm scale drawn from U[0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(variables["params"])
    for path, v in flat.items():
        if path[-1] == "scale":
            flat[path] = (0.5 + rng.random(v.shape)).astype(np.float32)
    return dict(variables, params=unflatten_dict(flat))


def _outputs(out):
    """A module's outputs as a list of NHWC/NC numpy arrays."""
    if isinstance(out, dict):
        out = [out["cls_out"]]
    elif not isinstance(out, (tuple, list)):
        out = [out]
    return [np.asarray(o) if not isinstance(o, torch.Tensor)
            else (_nhwc(o) if o.dim() == 4 else o.detach().numpy()) for o in out]


def _check(jm, tm, x, prefix, strip, train, tol=TOL):
    """jm(x, train) against tm(x) from the same variables: every output
    and, in training, both running statistics of every BatchNorm. ``tol``
    may be a function of the reference output."""
    v = _scaled(_init(jm, jnp.asarray(x), False))
    tm.load_state_dict(_bridge(v, prefix, strip), strict=True)
    tm.train(train)
    apply = jax.jit(lambda vv, xx: jm.apply(vv, xx, train, mutable=["batch_stats"]))
    jout, mutated = apply(v, jnp.asarray(x))
    with torch.no_grad():
        tout = tm(_nchw(x))
    for got, ref in zip(_outputs(tout), _outputs(jout), strict=True):
        np.testing.assert_allclose(got, ref, **(tol(ref) if callable(tol) else tol))
    if train:
        stats = _bridge({"batch_stats": mutated["batch_stats"]}, prefix, strip)
        sd = tm.state_dict()
        assert stats
        for k, ref in stats.items():
            if "running" in k:
                ref = ref.numpy()
                np.testing.assert_allclose(sd[k].numpy(), ref, err_msg=k,
                                           **(tol(ref) if callable(tol) else tol))


# ------------------------------------------------------------ max-pool

@pytest.mark.parametrize("shape", [(2, 9, 9, 3), (2, 8, 10, 4), (1, 7, 6, 2)])
@pytest.mark.parametrize("kernel,stride,padding", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_max_pool_matches_jax(shape, kernel, stride, padding):
    """Exact: a max picks one input, and the padding never wins."""
    x = _x(shape) - 3.0  # every value below 0, so a zero padding would win
    got = max_pool(torch.from_numpy(x), kernel, stride, padding).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_max_pool(jnp.asarray(x), kernel, stride,
                                                               padding)))


# ------------------------------------------------------------ blocks

# (inplanes, planes, stride, SFConv allowed): identity, SFConv in both convs;
# stride 2 with a downsample and a plain conv1 (block 0 of layer2); the
# channel change alone; a plain block; a stride-2 SFConv conv1
BASIC = [(8, 8, 1, True), (4, 8, 2, True), (4, 8, 1, False), (8, 8, 1, False), (8, 8, 2, True)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("inplanes,planes,stride,sf", BASIC)
def test_basic_block_matches_jax(inplanes, planes, stride, sf, train):
    x = _x((2, 9, 9, inplanes))
    down = stride != 1 or inplanes != planes
    jm = jres.BasicBlock(planes=planes, stride=stride, has_downsample=down,
                         freq_norm="ortho" if sf else None)
    tm = tres.BasicBlock(inplanes, planes, stride, down, sf)
    assert isinstance(tm.conv1, tl.SFConv) == (sf and inplanes == planes)
    assert isinstance(tm.conv2, tl.SFConv) == sf
    _check(jm, tm, x, *IN_STAGE, train)


# (inplanes, planes, stride): block 0 of a stage (stride-2 SFConv conv2 and a
# downsample), a later block (SFConv conv2 at stride 1, identity shortcut),
# layer1's block 0 (stride 1, downsample for the channels)
BOTTLENECK = [(16, 4, 2, True), (16, 4, 1, True), (8, 4, 1, False)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("inplanes,planes,stride,sf", BOTTLENECK)
def test_bottleneck_matches_jax(inplanes, planes, stride, sf, train):
    x = _x((2, 9, 9, inplanes))
    down = stride != 1 or inplanes != 4 * planes
    jm = jres.Bottleneck(planes=planes, stride=stride, has_downsample=down,
                         freq_norm="ortho" if sf else None)
    tm = tres.Bottleneck(inplanes, planes, stride, down, sf)
    assert [isinstance(c, tl.SFConv) for c in (tm.conv1, tm.conv2, tm.conv3)] == [False, sf, False]
    _check(jm, tm, x, *IN_STAGE, train)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_jax(arch):
    """The whole classifier ResNet with SFConv in stages 2-4, eval, 32²."""
    x = _x((2, 32, 32, 3))
    jm = jres.ResNet(arch=arch, num_classes=5, freq_norm="ortho")
    tm = tres.ResNet(arch, num_classes=5, freq_norm="ortho")
    _check(jm, tm, x, ("extractor", "net"), "extractor.", False)


def _deep_train_tol(ref):
    """ResNet-50's extractor in training normalises layer3 over 8 values a
    channel (2 images of 2x2) after 13 train-mode bottlenecks, and there
    the two fp32 runs part by 1.66e-3 (1.7e-4 of max |ref|), where in eval
    they agree within 1e-5; the JAX BatchNorm takes E[x^2] - E[x]^2, the
    port's the mean of squared deviations. So in training the outputs and
    statistics are held within 2e-4 of their max |ref|."""
    return dict(rtol=1e-4, atol=2e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["Res18", "Res50"])
def test_extractor_matches_jax(name, train):
    """Res18 returns layer3 and the 448-channel concat; Res50 layer3 (1024).
    Neither registers layer4 or a head (strict loading would fail)."""
    x = _x((2, 32, 32, 3))
    jm = getattr(jres, f"Extractor{name}")()
    tm = getattr(tres, f"Extractor{name}")()
    assert not hasattr(tm, "layer4") and not hasattr(tm, "fc")
    tol = _deep_train_tol if (name, train) == ("Res50", True) else TOL
    _check(jm, tm, x, ("extractor",), "extractor.", train, tol)


# (name, input channels, input size)
EMBEDDERS = [("Res18Layer1", 448, 8), ("Res18Layer2", 512, 4), ("Res50Layer1", 1024, 8),
             ("Res50Layer2", 2048, 4)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,c,hw", EMBEDDERS, ids=[e[0] for e in EMBEDDERS])
def test_embedder_matches_jax(name, c, hw, train):
    x = _x((2, hw, hw, c))
    jm = getattr(jres, f"Embedder{name}")()
    tm = getattr(tres, f"Embedder{name}")()
    _check(jm, tm, x, ("emb_block1",), "emb_block1.", train)


# train-mode blocks whose SFConv runs at stride 1 and at stride 2 (pooled
# to the output): (JAX module, port module, input shape)
BACKWARD = {
    "basic-s1": (lambda: jres.BasicBlock(planes=8, stride=1, has_downsample=False,
                                         freq_norm="ortho"),
                 lambda: tres.BasicBlock(8, 8, 1, False, True), (2, 9, 9, 8)),
    "basic-s2": (lambda: jres.BasicBlock(planes=8, stride=2, has_downsample=True,
                                         freq_norm="ortho"),
                 lambda: tres.BasicBlock(8, 8, 2, True, True), (2, 9, 9, 8)),
    "bottleneck-s2": (lambda: jres.Bottleneck(planes=4, stride=2, has_downsample=True,
                                              freq_norm="ortho"),
                      lambda: tres.Bottleneck(16, 4, 2, True, True), (2, 9, 9, 16)),
    "bottleneck-s1": (lambda: jres.Bottleneck(planes=4, stride=1, has_downsample=False,
                                              freq_norm="ortho"),
                      lambda: tres.Bottleneck(16, 4, 1, False, True), (2, 9, 9, 16)),
    "Res18Layer1": (jres.EmbedderRes18Layer1, tres.EmbedderRes18Layer1, (2, 8, 8, 448)),
    "Res50Layer1": (jres.EmbedderRes50Layer1, tres.EmbedderRes50Layer1, (2, 8, 8, 1024)),
}


@pytest.mark.parametrize("name", sorted(BACKWARD))
def test_block_backward_matches_jax(name):
    """One train-mode backward of sum(out * r), r seeded: the input gradient
    and every parameter's (sf_coef and freq_conv included) within 1e-4 of
    the tensor's max |ref|, and each sf_coef within 1e-4 of itself."""
    make_j, make_t, shape = BACKWARD[name]
    x = _x(shape)
    jm, tm = make_j(), make_t()
    v = _scaled(_init(jm, jnp.asarray(x), False))
    prefix, strip = IN_STAGE if "Layer" not in name else (("emb_block1",), "emb_block1.")
    tm.load_state_dict(_bridge(v, prefix, strip), strict=True)
    tm.train(True)
    out_shape = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x), True,
                                                mutable=["batch_stats"])[0]).shape
    r = _x(out_shape, 5)

    def loss(params, xx):
        out, _ = jm.apply({**v, "params": params}, xx, True, mutable=["batch_stats"])
        return jnp.sum(out * r)

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    (tm(xt) * _nchw(r)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgx), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(jgx)).max()))
    ref = _bridge({"params": jgp}, prefix, strip)
    got = dict(tm.named_parameters())
    assert set(ref) == set(got)
    for k, g in ref.items():
        g = g.numpy()
        np.testing.assert_allclose(got[k].grad.numpy(), g, rtol=1e-4 if k.endswith("sf_coef")
                                   else 0, atol=1e-4 * float(np.abs(g).max()), err_msg=k)


@pytest.mark.parametrize("theta", [0.0, 0.7])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_cdconv_matches_jax(theta, bias, stride):
    x = _x((2, 9, 9, 4))
    jm = jl.CDConv(6, 3, stride, 1, theta=theta, use_bias=bias)
    v = _init(jm, jnp.asarray(x))
    if bias:
        v["params"]["bias"] = _x((6,), 1)
    tm = tl.CDConv(4, 6, 3, stride, 1, theta=theta, bias=bias)
    tm.load_state_dict(_bridge(v, ("extractor", "conv1"), "extractor.conv1."), strict=True)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


# ------------------------------------------------------------ the models

def _udr_variables(name, size=64, batch=4, **fields):
    jm = JAX_MODELS[name](dtype=jnp.float32, **fields)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((batch, size, size, 3)), train=False)
    return jm, v


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["UDR18", "UDR50"])
def test_udr_model_matches_jax(name, train):
    """64², every rate 0: cls_out, rec and every loss_dict entry at rtol =
    atol = 1e-3, and in training the running statistics. Batch 4, each
    image at its own scale: in training the bottleneck normalises each
    channel over the batch, and at batch 2 a channel whose two pooled
    features nearly agree turns fp32 rounding into a 1% change. UDR50 in
    training takes an atol of 1e-3 of max |ref| instead: its extractor
    alone parts by 1.7e-4 of max |ref| (``_deep_train_tol``), and the
    embedders and the bottleneck grow that (one element of
    ``factorization`` 1.3e-3 off at batch 4)."""
    jm, v = _udr_variables(name, drop_rate=0.0, feat_drop_rate=0.0)
    v = _scaled(_randomise(v))
    tm = build_model(name, {"drop_rate": 0.0, "feat_drop_rate": 0.0})
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    tm.train(train)
    scale = np.linspace(0.5, 2.0, 4, dtype=np.float32)[:, None, None, None]
    x, noise = _x((4, 64, 64, 3), 3) * scale, _x((4, 64, 64, 3), 4) * scale[::-1]
    apply = jax.jit(lambda vv, a, b: jm.apply(vv, a, b, train=train, mutable=["batch_stats"]))
    jout, mutated = apply(v, jnp.asarray(x), jnp.asarray(noise))
    with torch.no_grad():
        tout = tm(_nchw(x), noise_x=_nchw(noise))
    deep = name == "UDR50" and train

    def close(got, ref, what):
        got = _nhwc(got) if got.dim() == 4 else got.numpy()
        ref = np.asarray(ref)
        atol = 1e-3 * (float(np.abs(ref).max()) if deep else 1.0)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol, err_msg=what)

    close(tout["cls_out"], jout["cls_out"], "cls_out")
    close(tout["rec"], jout["rec"], "rec")
    jl_, tl_ = jout["loss_dict"], tout["loss_dict"]
    assert set(jl_) == set(tl_)
    for key in ("factorization", "spatial", "freq", "freq_mask", "spat_mask"):
        close(tl_[key], jl_[key], key)
    assert len(tl_["triplet"]) == len(jl_["triplet"]) == 2
    for i, (t, j) in enumerate(zip(tl_["triplet"], jl_["triplet"])):
        close(t, j, f"triplet {i}")
    if train:
        stats = state_dict_from_jax({"batch_stats": mutated["batch_stats"]})
        sd = tm.state_dict()
        for k, ref in stats.items():
            if "running" in k:
                close(sd[k], ref.numpy(), k)


def _spread_bottleneck(jm, v, x):
    """Set the bottleneck's running statistics to the mean and variance of
    its inputs over the batch ``x`` (read with unit statistics), so each
    image's features sit about one standard deviation from the mean and the
    probabilities differ per image without saturating."""
    bn = v["batch_stats"]["bottleneck"]
    scale = v["params"]["bottleneck"]["scale"]
    bn["mean"], bn["var"] = np.zeros_like(bn["mean"]), np.ones_like(bn["var"])
    out = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(v, jnp.asarray(x))
    f = np.asarray(out["loss_dict"]["factorization"]) * np.sqrt(1 + 1e-5) / scale
    bn["mean"], bn["var"] = f.mean(0), f.var(0) + 1e-6


@pytest.mark.parametrize("name", ["UDR18", "UDR50"])
def test_state_dict_bridge_matches_export_and_loads_udr(name):
    """state_dict_from_jax == export_torch_state_dict key for key and value
    for value on the full tree, and loads strictly into the port."""
    shapes = jax.eval_shape(
        lambda: JAX_MODELS[name]().init({"params": jax.random.PRNGKey(0)},
                                        jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    variables = {k: dict(v) for k, v in variables.items()}
    ours = state_dict_from_jax(variables)
    ref = export_torch_state_dict(variables, "unidefense")
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    build_model(name, {}).load_state_dict(ours, strict=True)


@pytest.mark.parametrize("name", ["UDR18", "UDR50"])
def test_udr_predictor_matches_jax_eval_step_end_to_end(name):
    """Port Predictor (CPU) vs JAX make_eval_step(model, DevicePipeline()) at
    64², batch 2, same weights: probs, cls_out and rec at rtol = atol = 1e-3."""
    jm, v = _udr_variables(name, batch=2)
    v = _scaled(_randomise(v, classifier_std=0.05))
    rng = np.random.default_rng(7)
    ramp = np.broadcast_to(np.linspace(0, 255, 64)[None, :, None], (64, 64, 3))
    frames = np.stack([rng.integers(0, 256, (64, 64, 3)), ramp]).astype(np.uint8)
    _spread_bottleneck(jm, v, DevicePipeline()(jnp.asarray(frames)))
    tol = dict(rtol=1e-3, atol=1e-3)

    pred = Predictor.from_jax_variables(v, name, input_size=64, batch_size=2,
                                        dtype=torch.float32, device="cpu")
    eval_step = jax.jit(make_eval_step(jm, preprocess=DevicePipeline()))
    jp, jcls, jrec = eval_step(v["params"], v["batch_stats"], jnp.asarray(frames), None)
    np.testing.assert_allclose(pred.predict_frames(frames), np.asarray(jp), **tol)
    assert np.ptp(np.asarray(jp)) > 1e-3  # the probabilities do differ per frame
    with torch.inference_mode():
        _, tcls, trec = pred._eval(torch.from_numpy(frames))
    np.testing.assert_allclose(tcls.numpy(), np.asarray(jcls), **tol)
    np.testing.assert_allclose(_nhwc(trec), np.asarray(jrec), **tol)


@pytest.mark.parametrize("name", ["UDR18", "UDR50"])
def test_udr_predictor_defaults_to_cuda_and_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(name)


@pytest.mark.parametrize("name,res", sorted(k for k in chip_smoke.SFCONV_SHAPES
                                            if k[0] != "UDEB4"))
def test_udr_sfconv_shape_list(name, res):
    """chip_smoke.SFCONV_SHAPES (H=W, C, count per forward), from which the
    smoke run takes UDR's launch counts, against the inputs the port's model
    gives its SFConvs (a forward pre-hook; the frequency branch is skipped,
    since only the shapes are read)."""
    model = build_model(name, {}).eval()
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape[1:])))
             for m in model.modules() if isinstance(m, tl.SFConv)]
    try:
        with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(tl.SFConv, "forward", tl.Conv.forward)
            model(torch.zeros(1, 3, res, res))
    finally:
        for h in hooks:
            h.remove()
    counts = {}
    for c, h, w in seen:
        assert h == w
        counts[(h, c)] = counts.get((h, c), 0) + 1
    assert [(hw, c, n) for (hw, c), n in counts.items()] == chip_smoke.SFCONV_SHAPES[name, res]
    assert len(seen) == len(hooks) == (8 if name == "UDR18" else 12)
