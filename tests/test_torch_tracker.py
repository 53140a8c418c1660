"""The port's tracker against the JAX package's (CPU).

Integer and boolean outputs (assignments, slots, uids, emission flags,
overflow) must be exact.  Float outputs go through small matrix
products that torch and XLA sum in other orders: Kalman states and
boxes agree to float32 rounding, held at 1e-5 for the filter steps.
The scan over blocks is in ``test_torch_tracker_block.py``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from facerec_tpu.ops import assignment as jassign
from facerec_tpu.ops import boxes as jboxes
from facerec_tpu.ops import kalman as jkalman

from facerec_torch.ops import assignment, boxes, kalman

KF_RTOL, KF_ATOL = 1e-5, 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_iou_and_box_conversions_match_jax():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 9), random_boxes(rng, 7)
    b[0] = a[0]                      # identical pair
    b[1] = [5, 5, 5, 5]              # zero-area box
    np.testing.assert_allclose(
        boxes.iou_matrix(t(a), t(b)).numpy(),
        np.asarray(jboxes.iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)
    z = np.array(jboxes.box_to_z(jnp.asarray(a)))
    np.testing.assert_allclose(boxes.box_to_z(t(a)).numpy(), z, rtol=1e-6)
    z[0, 2] = -4.0                   # transient negative area
    np.testing.assert_allclose(
        boxes.z_to_box(t(z)).numpy(),
        np.asarray(jboxes.z_to_box(jnp.asarray(z))), rtol=1e-6, atol=1e-5)


def test_round_clip_box_and_iou_single_match_jax():
    rng = np.random.default_rng(1)
    for box in random_boxes(rng, 20):
        box = box + np.float32(0.5)      # half-pixel ties
        for pad in (0.0, 0.1):
            assert boxes.round_clip_box(box, 190, 150, pad) == \
                jboxes.round_clip_box(box, 190, 150, pad)
    a, b = [1, 2, 30, 40], [5, 6, 50, 45]
    assert boxes.iou_single(a, b) == jboxes.iou_single(a, b)


def test_inv4_and_kalman_steps_match_jax():
    rng = np.random.default_rng(2)
    m = rng.normal(size=(6, 4, 4)).astype(np.float32)
    s = (m @ m.transpose(0, 2, 1) + 4 * np.eye(4)).astype(np.float32)
    np.testing.assert_allclose(kalman.inv4(t(s)).numpy(),
                               np.asarray(jkalman.inv4(jnp.asarray(s))),
                               rtol=KF_RTOL, atol=KF_ATOL)
    np.testing.assert_allclose(kalman.inv4(t(s)).numpy() @ s,
                               np.broadcast_to(np.eye(4), s.shape),
                               atol=1e-5)

    n = 6
    x = rng.normal(size=(n, 8)).astype(np.float32) * 10
    x[0, 6], x[0, 2] = -50.0, 20.0       # positivity guard fires
    p = np.broadcast_to(jkalman.P0, (n, 8, 8)).copy()
    z = rng.normal(size=(n, 4)).astype(np.float32) * 10
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    jst = jkalman.KalmanState(jnp.asarray(x), jnp.asarray(p))
    st = kalman.KalmanState(t(x), t(p))
    for _ in range(3):
        jst = jkalman.update(jkalman.predict(jst), jnp.asarray(z),
                             jnp.asarray(mask))
        st = kalman.update(kalman.predict(st), t(z), t(mask))
        for g, w in zip(st, jst):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=KF_RTOL, atol=KF_ATOL)
    jr = jkalman.reset_tracks(jst, jnp.asarray(mask), jnp.asarray(z))
    r = kalman.reset_tracks(st, t(mask), t(z))
    for g, w in zip(r, jr):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=KF_RTOL, atol=KF_ATOL)


@pytest.mark.parametrize("seed", range(6))
def test_solve_lap_min_exact_with_ties(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 9))
    # few distinct values: many ties between optimal assignments
    cost = rng.integers(0, 4, (k, k)).astype(np.float32)
    want = np.asarray(jassign.solve_lap_min(jnp.asarray(cost)))
    got = assignment.solve_lap_min(t(cost)).numpy()
    np.testing.assert_array_equal(got, want)
    cost = rng.normal(size=(k, k)).astype(np.float32)
    np.testing.assert_array_equal(
        assignment.solve_lap_min(t(cost)).numpy(),
        np.asarray(jassign.solve_lap_min(jnp.asarray(cost))))


@pytest.mark.parametrize("d,tt", [(4, 6), (6, 4), (5, 5), (8, 3)])
def test_associate_exact_fast_path_and_solver(d, tt):
    rng = np.random.default_rng(d * 10 + tt)
    n_solved = 0
    for trial in range(12):
        iou = rng.uniform(0, 1, (d, tt)).astype(np.float32)
        if trial % 2:                  # ties and column conflicts
            iou = np.round(iou * 3) / 3
        dv = rng.uniform(size=d) < 0.8
        tv = rng.uniform(size=tt) < 0.8
        want = np.asarray(jassign.associate(
            jnp.asarray(iou), jnp.asarray(dv), jnp.asarray(tv), 0.3))
        got = assignment.associate(t(iou), t(dv), t(tv), 0.3).numpy()
        np.testing.assert_array_equal(got, want)
        n_solved += int(trial % 2)
    assert n_solved
