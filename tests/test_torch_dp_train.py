"""Data-parallel training steps against the one-process step on the
global batch.

JAX's ``jit`` over a batch sharded on a mesh computes the one-device
function of the global batch: BatchNorm's statistics and the triplet
mining see every row.  The port's trainers with a process ``group``
must take that step, so two gloo processes on the CPU, each with half
of the batch, are held in float64 to one process on the whole batch:
the loss, every gradient (within 1e-6 of the leaf's max |g|: a summed
rather than averaged gradient would be off by 2×), the BatchNorm
running statistics and the Adam update; and the ranks' parameters,
statistics and Adam state must be identical.  The one-process step is
held to JAX's in ``tests/test_torch_train.py`` and
``tests/test_torch_facenet_train.py``.  The dry run of every
multi-device path closes the file.

The worker processes import this module to find ``_dp_rank``; it
imports nothing of JAX.
"""
import numpy as np
import pytest
import torch

from facerec_torch.parallel.mesh import run_ranks

N = 2
TOL = 1e-6
# Adam's first step is lr·sign(g): updates compared where |g| is not
# rounding noise
G_FLOOR = 1e-6
# a leaf's max |g| is floored at this share of the model's largest:
# FaceNet's last Block8 bias has a gradient that vanishes exactly (the
# train-mode bottleneck BN subtracts the batch mean of its shift), so
# both sides hold only rounding there (chip_smoke.py STEP_GRAD_FLOOR)
LEAF_FLOOR = 1e-4


def _case(kind):
    """(trainer factory (device, group) in float64, global batch)."""
    from facerec_torch.models.detector import FaceDetector
    from facerec_torch.models.layers import init_weights
    from facerec_torch.train import DetectorTrainer
    from facerec_torch.train.facenet_train import FaceNetTrainer
    from facerec_torch.video.synth import identity_crops, synth_batch

    rng = np.random.default_rng(0)
    if kind == "detector":
        batch = synth_batch(rng, 4, 64, 64, max_faces=2,
                            face_size=(12.0, 30.0))

        def make(device, group):
            model = FaceDetector(backbone_width=16)
            init_weights(model, torch.Generator().manual_seed(0))
            return DetectorTrainer(model.to(torch.float64), (64, 64),
                                   device=device, group=group)
        return make, batch
    # 4 identities × 2 crops at 80² (the full net; 80² keeps every
    # valid convolution's output non-empty)
    crops = np.concatenate([identity_crops(rng, a, 2, size=80)
                            for a in range(4)])
    labels = np.repeat(np.arange(4, dtype=np.int32), 2)
    # rank r holds rows 4r..4r+3: two of each of its identities' crops,
    # so mining must cross the ranks to find negatives
    def make(device, group):
        trainer = FaceNetTrainer(16, learning_rate=3e-4, seed=0,
                                 device=device, group=group)
        trainer.model.to(torch.float64)
        return trainer
    return make, (crops, labels)


def _state(trainer, loss):
    host = lambda t: t.detach().to("cpu", torch.float64).numpy().copy()
    return {"loss": float(loss),
            "grads": {k: host(p.grad) for k, p in
                      trainer.model.named_parameters()},
            "params": {k: host(p) for k, p in
                       trainer.model.named_parameters()},
            "buffers": {k: host(b) for k, b in
                        trainer.model.named_buffers()}}


def _dp_rank(rank, device, kind):
    import torch.distributed as dist

    make, batch = _case(kind)
    trainer = make(device, dist.group.WORLD)
    shard = len(batch[0]) // dist.get_world_size()
    mine = [a[rank * shard:(rank + 1) * shard] for a in batch]
    out = _state(trainer, trainer.step(*mine))
    out["identical"] = trainer.replicas_identical()
    return out


@pytest.fixture(scope="module", params=["detector", "facenet"])
def steps(request):
    kind = request.param
    make, batch = _case(kind)
    trainer = make("cpu", None)
    one = _state(trainer, trainer.step(*batch))
    return kind, one, run_ranks(_dp_rank, ["cpu"] * N, args=(kind,))


def test_dp_step_equals_the_global_batch_step(steps):
    kind, one, ranks = steps
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=TOL)
        n_upd = 0
        top = max(np.abs(g).max() for g in one["grads"].values())
        for k, g in one["grads"].items():
            scale = max(np.abs(g).max(), LEAF_FLOOR * top)
            assert np.abs(r["grads"][k] - g).max() <= TOL * scale, k
            big = np.abs(g) >= G_FLOOR * scale
            np.testing.assert_allclose(r["params"][k][big],
                                       one["params"][k][big], rtol=0,
                                       atol=TOL, err_msg=k)
            n_upd += int(big.sum())
        assert n_upd > 100
        for k, b in one["buffers"].items():
            np.testing.assert_allclose(r["buffers"][k], b, rtol=0,
                                       atol=TOL, err_msg=k)


def test_dp_ranks_stay_identical(steps):
    kind, _, ranks = steps
    assert all(r["identical"] for r in ranks)
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)


def test_dryrun_multichip_on_two_cpu_processes(capsys):
    from facerec_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, devices=["cpu", "cpu"])
    assert np.isfinite(out["det_loss"]) and np.isfinite(out["facenet_loss"])
    assert "dryrun_multichip(2): extract+train OK" in capsys.readouterr().out
