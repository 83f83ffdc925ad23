"""The port's host utilities against the JAX package's: `utils/sample.py`
(`subsample`, `grid`) under the same numpy Generator, and `utils/viz.py`
(`anim_row`) frame by frame."""
import numpy as np
import pytest

from gaot3d_tpu.utils import sample as jsample
from gaot3d_tpu.utils import viz as jviz
from gaot3d_tpu_torch.utils import sample as tsample
from gaot3d_tpu_torch.utils import viz as tviz


@pytest.mark.parametrize("n", [7, 50, 500])
def test_subsample_matches_jax_under_the_same_generator(n):
    rng = np.random.default_rng(0)
    points = rng.normal(size=(120, 3)).astype(np.float32)
    values = rng.normal(size=(120, 2))
    labels = np.arange(120)
    want = jsample.subsample(points, n, values, labels, rng=np.random.default_rng(5))
    got = tsample.subsample(points, n, values, labels, rng=np.random.default_rng(5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(np.unique(got[2])) == min(n, 120)


@pytest.mark.parametrize("res,lo,hi", [((4, 3, 5), (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                                       ((6, 2), (0.0, -2.0), (3.0, 2.0))])
def test_grid_matches_jax(res, lo, hi):
    want = jsample.grid(res, lo, hi)
    got = tsample.grid(res, lo, hi)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def _frames(path):
    from PIL import Image
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
    return out


def test_anim_row_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    frames = [rng.normal(size=(3, 6, 5)), rng.uniform(size=(3, 6, 5))]
    jpath, tpath = str(tmp_path / "j.gif"), str(tmp_path / "t.gif")
    janim = jviz.anim_row(frames, titles=["a", "b"], save_path=jpath, interval=100)
    tanim = tviz.anim_row(frames, titles=["a", "b"], save_path=tpath, interval=100)
    assert type(tanim) is type(janim)
    want, got = _frames(jpath), _frames(tpath)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    single = tviz.anim_row([frames[0]])  # one panel, not saved
    assert single is not None
