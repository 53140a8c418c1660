"""The frozen painter paints the bytes of the port's clip painter."""
import numpy as np
import pytest

from facerec_torch.video.synth import make_frames, paint_frames
from portbench import film, painter


@pytest.mark.parametrize("kw", [
    dict(n_frames=40, width=96, height=80, seed=3, cuts=(11, 30),
         n_faces=2, identities=4),
    dict(n_frames=24, width=128, height=96, seed=2 ** 40 + 5, cuts=(7,),
         n_faces=5, identities=9),
    dict(n_frames=12, width=96, height=96, seed=0, cuts=(), n_faces=2,
         identities=0),
])
def test_painter_matches_port(kw):
    got = painter.paint(kw["n_frames"], kw["width"], kw["height"],
                        kw["seed"], kw["cuts"], kw["n_faces"],
                        kw["identities"])
    assert np.array_equal(got, paint_frames(**kw).frames[:])
    assert np.array_equal(got, make_frames(**kw).frames)


def test_shot_lengths_fill_the_pool_inside_the_range():
    for n in (512, 1024):
        lengths = film.shot_lengths(n, 100, 250, 175)
        assert sum(lengths) == n
        assert all(100 <= x <= 250 for x in lengths)


def test_seeds_share_shot_lengths_in_their_own_order(tiny_cell):
    _, config, traffic, _ = tiny_cell
    a = film.plan(config, traffic, 1)
    b = film.plan(config, traffic, 2 ** 31 + 7)
    assert a[0] == b[0]
    la = np.diff([0] + a[1] + [a[0]])
    lb = np.diff([0] + b[1] + [b[0]])
    assert sorted(la) == sorted(lb)
    # each shot keeps its face sizes, whatever the order
    assert sorted(zip(la.tolist(), map(str, a[2]))) == \
        sorted(zip(lb.tolist(), map(str, b[2])))
    assert a[3] != b[3]
    assert film.plan(config, traffic, 1) == a


def test_looped_frames_are_views_of_the_pool():
    pool = np.arange(6 * 2 * 2 * 3, dtype=np.uint8).reshape(6, 2, 2, 3)
    frames = film.Film(pool, 20, 25.0).frames
    assert frames.shape == (20, 2, 2, 3)
    view = frames[6:9]
    assert np.shares_memory(view, pool) and np.array_equal(view, pool[:3])
    assert np.array_equal(frames[4:8], pool[[4, 5, 0, 1]])
