"""BN recalibration: the port's ``recalibrate_batch_stats`` against the
JAX package's (CPU).

On the detector, whose every BatchNorm is a ``ConvBN`` at momentum
0.995, the port's recalibrated statistics equal the JAX function's
within rtol 1e-4 (atol 1e-5): the unwind divides by 1 − m^K, 0.015 for
three batches, which magnifies the float32 rounding of the running
averages 67 times.  FaceNet's bottleneck BN runs at 0.99, which the JAX
function (one momentum for every leaf) does not unwind; the port takes
each module's own momentum, so a calibration set of one batch repeated
unwinds every leaf, the 0.99 one included, to that batch's statistics
(same tolerance).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from facerec_tpu.models.detector import FaceDetector as JaxDetector
from facerec_tpu.train.recalibrate import \
    recalibrate_batch_stats as jax_recalibrate

from facerec_torch.models import convert
from facerec_torch.models.detector import FaceDetector
from facerec_torch.models.facenet import FaceNet
from facerec_torch.models.layers import BatchNorm, init_weights
from facerec_torch.train.recalibrate import recalibrate_batch_stats
from tests.test_torch_detector import _numpy_tree, _perturb

STATS_ATOL = 1e-5
STATS_RTOL = 1e-4


def _batches(rng, n, shape=(2, 64, 64, 3)):
    return [rng.normal(0.2, 1.0, shape).astype(np.float32) for _ in range(n)]


def test_detector_recalibration_matches_jax():
    rng = np.random.default_rng(0)
    jmodel = JaxDetector(backbone_width=16)
    variables = _numpy_tree(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 64, 64, 3))))
    _perturb(variables, rng)
    batches = _batches(rng, 3)

    @jax.jit
    def apply_batch(v, x):
        _, mut = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
        return mut["batch_stats"]

    want = _numpy_tree(jax_recalibrate(
        jax.tree.map(jnp.asarray, variables),
        [jnp.asarray(b) for b in batches], apply_batch))

    port = FaceDetector(backbone_width=16)
    port.load_state_dict(convert.detector_state_dict(variables))
    params = {k: p.detach().clone() for k, p in port.named_parameters()}
    port.eval()
    n = recalibrate_batch_stats(
        port, batches,
        forward=lambda m, x: m(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert n == 3 and not port.training        # its mode comes back
    state = port.state_dict()
    for p, w in convert.flatten({"batch_stats": want["batch_stats"]}).items():
        np.testing.assert_allclose(state[convert._torch_key(p)].numpy(), w,
                                   rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=str(p))
    for k, p in port.named_parameters():
        assert torch.equal(p, params[k]), k


def _bn_inputs(model, x):
    """Each BatchNorm's batch statistics (mean, biased var) on ``x``,
    read by hooks in a train-mode forward of a copy."""
    stats = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: stats.__setitem__(name, (
            inp[0].mean(dim=[0] + list(range(2, inp[0].dim()))),
            inp[0].var(dim=[0] + list(range(2, inp[0].dim())),
                       unbiased=False))))
        for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    model.train()
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return stats


def test_each_module_unwinds_at_its_own_momentum():
    """FaceNet on one batch repeated four times: every leaf, the 0.99
    bottleneck among the 0.995 ConvBNs, unwinds to that batch's own
    statistics.  Unwinding the bottleneck at 0.995, as the JAX function
    would, leaves a share of its initial statistics behind."""
    torch.manual_seed(0)
    model = FaceNet(128)
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn(4, 3, 96, 96)
    bott = model.Bottleneck_BatchNorm
    assert bott.momentum == 0.99
    ra0 = (bott.mean.clone(), bott.var.clone())
    probe = FaceNet(128)
    probe.load_state_dict(model.state_dict())
    want = _bn_inputs(probe, x)

    model.eval()
    recalibrate_batch_stats(model, [x] * 4)
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            mean, var = want[name]
            np.testing.assert_allclose(m.mean.numpy(), mean.numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=name)
            np.testing.assert_allclose(
                m.var.numpy(), var.clamp_min(1e-6).numpy(), rtol=STATS_RTOL,
                atol=STATS_ATOL, err_msg=name)

    # the running mean after 4 passes at 0.99, unwound at 0.995 instead
    ra4 = 0.99 ** 4 * ra0[0] + (1 - 0.99 ** 4) * want["Bottleneck_BatchNorm"][0]
    wrong = (ra4 - 0.995 ** 4 * ra0[0]) / (1 - 0.995 ** 4)
    assert float((wrong - want["Bottleneck_BatchNorm"][0]).abs().max()) \
        > 100 * STATS_ATOL


def test_constant_input_and_zero_batches():
    """A constant input has zero batch variance: the clamp keeps it at
    1e-6 (as the JAX function's guard).  No batch at all raises."""
    bn = BatchNorm(3, momentum=0.995)
    x = torch.ones(4, 3, 2, 2)
    recalibrate_batch_stats(bn, [x, x])
    assert float(bn.var.min()) >= 1e-6 - 1e-12
    np.testing.assert_allclose(bn.mean.numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="at least one batch"):
        recalibrate_batch_stats(bn, [])
