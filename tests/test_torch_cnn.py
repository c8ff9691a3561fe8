"""The port's CNNs against the JAX reference: the reference's parameters
carried across with ``convert.cnn_state_dict``, then the logits (eval and
train mode, square and non-square inputs, so every asymmetric ``"SAME"``
pad is exercised) and ResNet-50's parameter gradients agree within
``rtol=1e-4`` and ``atol=1e-4·max|ref|``; the FLOP count equals the analytic
full-tap count and the byte count its written formula."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.models import cnn

RTOL = 1e-4
ATOL_SCALE = 1e-4  # × the largest |reference value|

# Analytic full-tap conv + fc FLOPs of a batch-1 forward pass at 224×224.
FULL_TAP_FLOPS = {"alexnet": 2_270_512_192, "googlenet": 3_165_343_744,
                  "resnet50": 7_715_946_496}
PARAMS = {"alexnet": 62_378_344, "googlenet": 6_998_552, "resnet50": 25_610_152}


def _perturbed(tree, rng):
    """The reference tree with every bias and batch-norm entry (zeros and
    ones at init) drawn at random, so a swapped mapping cannot pass."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                    if k in ("scale", "var") else
                    rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
                    if k in ("b", "bias", "mean") else _perturbed(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed(v, rng) for v in tree]
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    init, _ = ref_cnn.MODELS[name]
    return _perturbed(jax.device_get(init(jax.random.PRNGKey(0))), np.random.default_rng(1))


def _port_model(name, train):
    model = cnn.MODELS[name](device="cpu")
    model.load_state_dict(convert.cnn_state_dict(name, _ref_params(name)))
    return model.train(train)


def _image(batch, h, w, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, h, w, 3)).astype(np.float32)


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SCALE * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("name,batch,hw,train", [
    ("alexnet", 1, (224, 224), False),
    ("googlenet", 2, (64, 64), False),
    ("googlenet", 2, (64, 64), True),
    ("googlenet", 2, (65, 67), False),
    ("resnet50", 2, (64, 64), False),
    ("resnet50", 2, (64, 64), True),
    ("resnet50", 2, (65, 67), False),
    ("resnet50", 2, (65, 67), True),
    ("resnet50", 2, (64, 96), True),
])
def test_logits_equal_reference(name, batch, hw, train):
    x = _image(batch, *hw)
    _, apply = ref_cnn.MODELS[name]
    want = np.asarray(jax.jit(functools.partial(apply, train=train))(
        _ref_params(name), jnp.asarray(x)))
    with torch.no_grad():
        got = _port_model(name, train)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (batch, 1000)
    _assert_close(got, want, f"{name} {hw} train={train}")


@pytest.mark.parametrize("train,dtype", [(False, np.float32), (True, np.float64)])
def test_resnet50_gradients_equal_reference(train, dtype):
    """Gradients of ``(out**2).mean()`` w.r.t. every parameter.  Training
    mode runs in float64 on both sides: at 64×64 the last stage's batch
    norm sees 8 values a channel, and dividing by their spread makes the
    float32 gradient ill-conditioned (in float32 the port and JAX each stray
    from their float64 result by 1e-2 and more), so only float64 tests the
    semantics there."""
    x = _image(2, 64, 64, seed=3).astype(dtype)
    _, apply = ref_cnn.MODELS["resnet50"]
    params = jax.tree.map(lambda a: a.astype(dtype), _ref_params("resnet50"))

    def loss(p):
        return (apply(p, jnp.asarray(x), train=train) ** 2).mean()

    with jax.enable_x64(dtype == np.float64):
        grads = jax.device_get(jax.jit(jax.grad(loss))(params))
    want = convert.cnn_state_dict("resnet50", grads)
    model = _port_model("resnet50", train).to(torch.float64 if dtype == np.float64 else
                                              torch.float32)
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad((out ** 2).mean(), params)
    assert len(names) == 161
    for name, g in zip(names, grads):
        _assert_close(g.numpy(), want[name].numpy(), name)


def test_same_pad_matches_xla():
    """The pads of the reference's SAME layers at 224×224."""
    assert cnn.same_pad(224, 7, 2) == (2, 3)  # the 7×7/2 stems
    assert cnn.same_pad(112, 3, 2) == (0, 1)  # 3×3/2 max-pools
    assert cnn.same_pad(28, 3, 1) == (1, 1)  # the 3×3/1 inception pool
    assert cnn.same_pad(56, 1, 2) == (0, 0)  # ResNet's strided 1×1 convs
    assert cnn.same_pad(65, 7, 2) == (3, 3)
    assert cnn.same_pad(34, 3, 2) == (0, 1)
    for n in range(1, 80):
        for k, s in ((1, 1), (1, 2), (3, 1), (3, 2), (5, 1), (7, 2), (11, 4)):
            lo, hi = cnn.same_pad(n, k, s)
            assert (n + lo + hi - k) // s + 1 == -(-n // s) and 0 <= hi - lo <= 1


def test_model_flops_equal_full_tap_count_and_reference_ratio():
    """``model_flops`` equals the analytic full-tap count and the sum of
    ``FlopCounter.conv``/``fc`` over the layers; XLA's count (the
    reference's) leaves out taps on padding, so the port's is 1.00 to 1.10
    times as large."""
    for name, want in FULL_TAP_FLOPS.items():
        got = cnn.model_flops(name)
        assert got["flops"] == want and got["params"] == PARAMS[name], name
        counter = cnn.FlopCounter()
        for layer in cnn.step_layers(name):
            if layer.kind == "conv":
                cout, _, k, _ = layer.weight_shape
                assert layer.out_shape[2] == layer.out_shape[3]
                counter.conv(layer.out_shape[2], k, layer.in_shape[1], cout)
            elif layer.kind == "fc":
                counter.fc(layer.weight_shape[1], layer.weight_shape[0])
        assert counter.flops == want, name
        ref = ref_cnn.model_flops(name)
        assert ref["params"] == PARAMS[name]
        assert 1.0 <= got["flops"] / ref["flops"] <= 1.10, (name, ref["flops"])


def test_step_cost_scales_with_batch_and_training():
    for name in cnn.MODELS:
        f1, _ = cnn.step_cost(name, 1)
        f8, _ = cnn.step_cost(name, 8)
        t8, _ = cnn.step_cost(name, 8, train=True)
        assert f8 == 8 * f1
        # backward: input and weight gradients of every layer but the
        # first's input gradient
        assert 2.9 * f8 < t8 < 3 * f8, name


def test_alexnet_bytes_equal_written_formula():
    """fp32; each conv, linear and max-pool reads its input and weight once
    and writes its output once; training adds out-grad + input + weight
    reads and input-grad + weight-grad writes, but no image gradient."""
    layers = [  # (input, weight, output) elements at batch 1, 224×224
        (3 * 224 * 224, 96 * 3 * 11 * 11, 96 * 55 * 55),
        (96 * 55 * 55, 0, 96 * 27 * 27),
        (96 * 27 * 27, 256 * 96 * 5 * 5, 256 * 27 * 27),
        (256 * 27 * 27, 0, 256 * 13 * 13),
        (256 * 13 * 13, 384 * 256 * 9, 384 * 13 * 13),
        (384 * 13 * 13, 384 * 384 * 9, 384 * 13 * 13),
        (384 * 13 * 13, 256 * 384 * 9, 256 * 13 * 13),
        (256 * 13 * 13, 0, 256 * 6 * 6),
        (9216, 9216 * 4096, 4096), (4096, 4096 * 4096, 4096), (4096, 4096 * 1000, 1000),
    ]
    fwd = 4 * sum(i + w + o for i, w, o in layers)
    bwd = 4 * sum(o + 2 * i + 2 * w for i, w, o in layers) - 4 * layers[0][0]
    assert cnn.model_flops("alexnet")["bytes"] == fwd
    assert cnn.step_cost("alexnet", 1)[1] == fwd
    assert cnn.step_cost("alexnet", 1, train=True)[1] == fwd + bwd
    got = [(l.in_elems, l.weight_elems, l.out_elems) for l in cnn.step_layers("alexnet")]
    assert got == layers


def test_state_dict_conversion_layouts_and_mismatch():
    params = _ref_params("alexnet")
    sd = convert.cnn_state_dict("alexnet", params)
    np.testing.assert_array_equal(sd["conv.0.weight"].numpy(),
                                  params["conv"][0]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.2.weight"].numpy(), params["fc"][2]["w"].T)
    np.testing.assert_array_equal(sd["fc.2.bias"].numpy(), params["fc"][2]["b"])
    with pytest.raises(ValueError, match="do not match"):
        convert.cnn_state_dict("googlenet", params)


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.AlexNet()
