"""The port's ArcFace IResNet-100 (``facerec_torch/models/iresnet.py``)
against the plain reference (``tests/plain_arcface.py``, written from
the published layer list), on seeded weights on the CPU: at a depth of
one or two blocks a stage and at the published depth, the published
state-dict layout, the channel-first flatten, and faults the comparison
must see."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facerec_torch.models.iresnet import ArcFaceEmbedder, IResNet
from tests import plain_arcface as plain

ATOL = 1e-5


def seeded_state(layers, seed=0):
    """A state dict of the published layout with every term drawn:
    LeCun kernels, batch-norm scales near 1 (each block's last scaled
    by 0.2, so that the residual stream stays bounded), statistics and
    offsets, PReLU slopes and the dense bias; the last scale 1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in plain.shapes(layers).items():
        if key.endswith("num_batches_tracked"):
            v = np.zeros(shape, np.int64)
        elif len(shape) > 1:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        elif key == "features.weight":
            v = np.ones(shape)
        elif key.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, shape)
        elif key.endswith("prelu.weight"):
            v = rng.uniform(0.1, 0.4, shape)
        elif key.endswith("weight"):
            v = rng.uniform(0.8, 1.2, shape) * (
                0.2 if key.endswith("bn3.weight") else 1.0)
        else:
            v = rng.normal(0, 0.1, shape)
        sd[key] = torch.from_numpy(v if v.dtype == np.int64
                                   else v.astype(np.float32))
    return sd


def crops(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3, 112, 112), generator=g) * 2 - 1


def model(layers, sd):
    m = IResNet(layers)
    m.load_state_dict(sd, strict=True)
    return m.eval()


@pytest.mark.parametrize("layers", [(1, 1, 2, 1), (3, 13, 30, 3)])
def test_iresnet_matches_the_reference(layers):
    sd = seeded_state(layers)
    x = crops(2)
    with torch.no_grad():
        got = model(layers, sd)(x)
        want = plain.network(sd, x, layers)
    assert got.shape == (2, 512)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    emb = ArcFaceEmbedder("a", "cpu", state_dict=sd, layers=layers)(x)
    torch.testing.assert_close(emb, F.normalize(want, dim=1), rtol=0,
                               atol=ATOL)


def test_state_dict_is_the_published_layout():
    got = {k: tuple(v.shape) for k, v in IResNet().state_dict().items()}
    want = plain.shapes()
    assert list(got) == list(want)
    assert got == want
    assert got["fc.weight"] == (512, 512 * 7 * 7)
    assert torch.equal(IResNet().features.weight, torch.ones(512))


def test_flatten_is_channel_first():
    layers = (1, 1, 1, 1)
    sd = seeded_state(layers, seed=2)
    x = crops(2, seed=3)
    with torch.no_grad():
        last = plain.trunk(sd, x, layers)[-1]
        got = model(layers, sd)(x)
        bn = F.batch_norm(last, sd["bn2.running_mean"], sd["bn2.running_var"],
                          sd["bn2.weight"], sd["bn2.bias"], False, 0.0, 1e-5)
        nhwc = F.linear(bn.permute(0, 2, 3, 1).flatten(1), sd["fc.weight"],
                        sd["fc.bias"])
        nhwc = F.batch_norm(nhwc, sd["features.running_mean"],
                            sd["features.running_var"],
                            sd["features.weight"], sd["features.bias"],
                            False, 0.0, 1e-5)
    torch.testing.assert_close(got, plain.head(sd, last), rtol=0, atol=ATOL)
    assert float((got - nhwc).abs().max()) > 100 * ATOL


@pytest.mark.parametrize("fault", ["features", "prelu"])
def test_faults_no_longer_match(fault):
    layers = (1, 1, 2, 1)
    sd = seeded_state(layers, seed=4)
    m = model(layers, sd)
    if fault == "features":
        m.features = torch.nn.Identity()
    else:
        for name, mod in list(m.named_modules()):
            for child, sub in list(mod.named_children()):
                if isinstance(sub, torch.nn.PReLU):
                    setattr(mod, child, torch.nn.ReLU())
    x = crops(2, seed=5)
    with torch.no_grad():
        gap = float((m(x) - plain.network(sd, x, layers)).abs().max())
    assert gap > 100 * ATOL


def test_random_init_is_seeded_and_bounded():
    x = crops(2, seed=6)
    a = ArcFaceEmbedder("a", "cpu", seed=7, layers=(1, 1, 2, 1))(x)
    b = ArcFaceEmbedder("a", "cpu", seed=7, layers=(1, 1, 2, 1))(x)
    assert torch.equal(a, b)
    assert torch.allclose(a.norm(dim=1), torch.ones(2))
