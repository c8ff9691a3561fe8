"""VGG-16 on the simulated PIM (``repro_torch.pim.conv``,
``repro_torch.models.vgg``) against its plain reference
(``repro_torch.models.vgg_reference``): the conv lowering bit for bit, the
reference's chain within a stated error bound of the float64 convolution,
the tiny configuration-D preset end to end on both bases, and the import
rules.  The nine-tap program compiles once a process and basis (about 5 s
each on the CPU); a card test runs the same on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_vgg.py
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core import spans
from repro_torch.models import vgg
from repro_torch.models import vgg_reference as ref
from repro_torch.pim import conv

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))
BASES = ["memristive", "dram"]
SPECIALS = [float("inf"), float("-inf"), float("nan"), 1e-45, -1e-45, -0.0, 3.4028235e38,
            1.1754942e-38]


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return ref.differing(got, want) == 0


@pytest.mark.parametrize("got, want, n", [
    ([1.0, float("nan"), -0.0], [1.0, float("nan"), -0.0], 0),
    ([1.0, 2.0, 0.0], [1.0, 2.0000002, -0.0], 2),
    ([float("nan"), 1.0], [float("inf"), 1.0], 1),
    ([1.0, 2.0], [1.0, 2.0, 3.0], 3),
], ids=["equal", "an ulp and a sign", "nan against inf", "shapes"])
def test_differing_counts_bits_and_takes_any_nan_for_any_nan(got, want, n):
    got, want = torch.tensor(got), torch.tensor(want)
    if n == 0:  # another NaN payload is still equal
        got[1] = torch.tensor(0x7FC00001, dtype=torch.int32).view(torch.float32)
    assert ref.differing(got, want) == n


def _conv_case(n, cin, cout, h, w, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, h, w, generator=g)
    wt = torch.randn(cout, cin, 3, 3, generator=g)
    b = torch.randn(cout, generator=g)
    flat = x.view(-1)
    flat[torch.randperm(flat.numel(), generator=g)[:len(SPECIALS)]] = torch.tensor(SPECIALS)
    wt.view(-1)[:2] = torch.tensor([-0.0, 1e-45])
    return x.to(device), wt.to(device), b.to(device)


@pytest.fixture(scope="module", params=BASES)
def basis(request):
    """Each basis, its nine-tap schedule compiled once for the module."""
    conv.PROGRAM.compiled(request.param)
    return request.param


@pytest.mark.parametrize("shape", [(2, 2, 3, 6, 6), (2, 3, 4, 8, 8), (2, 2, 2, 7, 6)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_equals_the_chain(basis, shape):
    x, w, b = _conv_case(*shape, seed=sum(shape))
    got = conv.conv3x3(x, w, b, basis=basis)
    want = ref.conv3x3_chain(x, w, b)
    assert got.isnan().any() and got.isinf().any()  # the specials reach the outputs
    assert same_bits(got, want)


def _gamma(n: int, u: float) -> float:
    return n * u / (1 - n * u)


@pytest.mark.parametrize("cin", [1, 3, 16, 64])
def test_the_chain_is_within_its_bound_of_the_float64_conv(cin):
    """Bound.  A row computes s = b + sum_j p_j, p_j = x_j * w_j over m =
    9·cin taps, as q_j = fl(p_j) = p_j (1 + e_j) and s_j = fl(s_{j-1} +
    q_j) = (s_{j-1} + q_j)(1 + d_j) from s_0 = b, each |e|, |d| <= u =
    2^-24 (float32, round to nearest, no underflow or overflow: the inputs
    are N(0, 1)).  Unrolled, s_m = b prod_k (1 + d_k) + sum_j p_j (1 + e_j)
    prod_{k>=j} (1 + d_k): every term carries at most n = m + 1 factors
    (1 + t), |t| <= u, so (Higham, Lemma 3.1) it is the exact term times
    (1 + T), |T| <= gamma_n = n u / (1 - n u).  Hence |s_m - s| <= gamma_n
    (|b| + sum_j |x_j w_j|).  F.conv2d in float64 carries the same bound at
    u = 2^-53 (any summation order), added.  With bfloat16 products (u =
    2^-8) the chain must break the bound."""
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(2, cin, 9, 9, generator=g)
    w = torch.randn(5, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5
    b = torch.randn(5, generator=g)
    n = 9 * cin + 1
    exact = ref.conv3x3_exact(x, w, b)
    scale = ref.conv3x3_exact(x.abs(), w.abs(), b.abs())
    bound = (_gamma(n, 2.0 ** -24) + _gamma(n, 2.0 ** -53)) * scale
    err = (ref.conv3x3_chain(x, w, b).double() - exact).abs()
    assert bool((err <= bound).all()), float((err / bound).max())
    low = ref.conv3x3_chain(x.bfloat16(), w.bfloat16(), b.bfloat16()).double()
    assert bool(((low - exact).abs() > bound).any())


def _tiny(seed: int):
    """The tiny preset with biases drawn too, so that no ReLU zeroes a
    whole sample."""
    g = torch.Generator().manual_seed(seed)
    params = vgg.init_params(vgg.TINY, 32, device="cpu", generator=g)
    params["convs"] = [[(w, torch.rand(w.shape[0], generator=g) * 0.5) for w, _ in group]
                       for group in params["convs"]]
    params["fc"] = [(w, torch.rand(w.shape[0], generator=g) * 0.5) for w, _ in params["fc"]]
    return params, torch.randn(2, 3, 32, 32, generator=g)


def test_tiny_vgg_equals_the_reference(basis):
    params, x = _tiny(5)
    got_layers, want_layers = [], []
    before = spans.counters("conv.")
    logits = vgg.pim_forward(params, x, basis, keep=got_layers)
    want = ref.forward(params, x, keep=want_layers)
    assert len(got_layers) == len(want_layers) == 13
    assert all(same_bits(a, b) for a, b in zip(got_layers, want_layers))
    assert logits.shape == (2, 3) and same_bits(logits, want)
    assert bool((logits != 0).any(dim=1).all())
    calls = sum(cin for cin, _, _ in vgg.conv_layers(vgg.TINY, 32))
    assert spans.counters("conv.")["conv.waves"] - before.get("conv.waves", 0) == calls


def test_the_tables_of_configuration_d():
    """Thirteen conv layers of 3 715 calls in all, the classifier 33 280
    waves and 0.99 G MACs at batch 8 x 224²."""
    layers = vgg.conv_layers(vgg.CONFIG_D, 224)
    assert len(layers) == 13 and layers[0] == (3, 64, 224) and layers[-1] == (512, 512, 14)
    assert sum(c for _, c in vgg.conv_waves(vgg.CONFIG_D, 8, 224)) == 3715
    assert vgg.fc_layers(vgg.CONFIG_D, 224) == [(25088, 4096), (4096, 4096), (4096, 1000)]
    fc = vgg.fc_waves(vgg.CONFIG_D, 8, 224)
    assert sum(c for _, c in fc) == 33_280
    assert sum(r * c for r, c in fc) == 989_069_312
    with pytest.raises(ValueError):
        vgg.conv_layers(vgg.CONFIG_D, 100)


def test_seeded_parameters_repeat():
    a = vgg.init_params(vgg.TINY, 32, device="cpu", generator=torch.Generator().manual_seed(3))
    b = vgg.init_params(vgg.TINY, 32, device="cpu", generator=torch.Generator().manual_seed(3))
    flat = lambda p: [t for g in p["convs"] for wb in g for t in wb] + [  # noqa: E731
        t for wb in p["fc"] for t in wb]
    assert all(torch.equal(s, t) for s, t in zip(flat(a), flat(b)))
    assert [w.shape for w, _ in a["fc"]] == [(4, 2), (4, 4), (3, 4)]
    assert all(not bias.any() for bias in flat(a)[1::2])


def test_conv3x3_refuses_bad_arguments():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError):
        conv.conv3x3(x, torch.zeros(3, 1, 3, 3), torch.zeros(3))
    with pytest.raises(ValueError):
        conv.conv3x3(x, torch.zeros(3, 2, 3, 3), torch.zeros(2))
    with pytest.raises(TypeError):
        conv.conv3x3(x.double(), torch.zeros(3, 2, 3, 3), torch.zeros(3))


def _python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", f"import sys; sys.path[:0] = [{SRC!r}]\n" + code],
                          capture_output=True, text=True, timeout=120, env=env)


def test_the_reference_imports_torch_alone():
    """Loaded on its own from its file, the reference loads no module of the
    port, of JAX or of the JAX package; its source imports torch only."""
    path = os.path.join(SRC, "repro_torch", "models", "vgg_reference.py")
    proc = _python(f"""
import importlib.util
spec = importlib.util.spec_from_file_location("vgg_reference", {path!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro_torch", "repro", "jax", "jaxlib", "ml_dtypes"))
assert not bad, bad
""")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tree = ast.parse(open(path).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "torch", "torch.nn.functional"}


def test_importing_the_pim_frontend_loads_no_conv_and_compiles_nothing():
    proc = _python("""
import repro_torch.pim
assert "repro_torch.pim.conv" not in sys.modules
assert "repro_torch.models.vgg" not in sys.modules
import repro_torch.pim.conv, repro_torch.models.vgg
from repro_torch.core import spans
assert spans.counters("ir.compile.") == {}, spans.counters()
""")
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("card_basis", BASES)
def test_card_conv3x3_and_tiny_vgg_equal_the_reference(card_basis):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    for shape in [(2, 3, 8, 16, 16), (1, 2, 5, 7, 9)]:
        x, w, b = _conv_case(*shape, seed=sum(shape), device=cuda)
        before = spans.counters("exec.")
        got = conv.conv3x3(x, w, b, basis=card_basis)
        assert same_bits(got, ref.conv3x3_chain(x, w, b))
        moved = {k: v - before.get(k, 0) for k, v in spans.counters("exec.").items()}
        assert moved["exec.launches.bitserial_loop"] == shape[1]
    params, x = _tiny(6)
    params = {k: [[(w.to(cuda), b.to(cuda)) for w, b in g] for g in v] if k == "convs"
              else [(w.to(cuda), b.to(cuda)) for w, b in v] for k, v in params.items()}
    x = x.to(cuda)
    assert same_bits(vgg.pim_forward(params, x, card_basis), ref.forward(params, x))
