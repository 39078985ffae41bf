"""The ``torch.save`` checkpoint backend (``ocean_torch/io/torch_ckpt.py``)
against ``ocean_jax.io.orbax_ckpt`` and the timing utilities
(``ocean_torch/utils/timing.py``).

A round trip returns the saved control exactly (``torch.equal``) with the
same (lr, iteration) as the Orbax backend, the None cases included. The
loader puts the control on the device asked for, the card by default,
and raises without one.
"""

import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ocean_jax.control import Control as JaxControl
from ocean_jax.io import orbax_ckpt

from ocean_torch.control import Control
from ocean_torch.io import torch_ckpt
from ocean_torch.utils import Timer, sync

torch.set_num_threads(2)


def _control(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((5, 3, 2)), rng.standard_normal((11, 2))


@pytest.mark.parametrize("lr, iteration", [(0.25, 7), (None, 3), (1.5, None),
                                           (None, None)])
def test_round_trip_matches_orbax(tmp_path, lr, iteration):
    quad, p2 = _control(0)
    torch_ckpt.save_control(str(tmp_path / "q.pt"),
                            Control(torch.as_tensor(quad),
                                    torch.as_tensor(p2)), lr, iteration)
    got, lr_t, it_t = torch_ckpt.load_control(str(tmp_path / "q.pt"),
                                              device="cpu")
    orbax_ckpt.save_control(str(tmp_path / "orbax"),
                            JaxControl(jnp.asarray(quad), jnp.asarray(p2)),
                            lr, iteration)
    ref, lr_j, it_j = orbax_ckpt.load_control(str(tmp_path / "orbax"))
    assert torch.equal(got.quad, torch.as_tensor(np.asarray(ref.quad)))
    assert torch.equal(got.p2, torch.as_tensor(np.asarray(ref.p2)))
    assert (lr_t, it_t) == (lr_j, it_j) == (lr, iteration)


def test_interrupted_write_keeps_the_old_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "q.pt")
    quad, p2 = _control(1)
    old = Control(torch.as_tensor(quad), torch.as_tensor(p2))
    torch_ckpt.save_control(path, old, 0.5, 2)

    def interrupted(src, dst):
        raise KeyboardInterrupt

    monkeypatch.setattr(torch_ckpt.os, "replace", interrupted)
    with pytest.raises(KeyboardInterrupt):
        torch_ckpt.save_control(path, old.scale(2.0), 0.25, 3)
    monkeypatch.undo()
    got, lr, it = torch_ckpt.load_control(path, device="cpu")
    assert torch.equal(got.quad, old.quad) and torch.equal(got.p2, old.p2)
    assert (lr, it) == (0.5, 2)
    assert os.listdir(tmp_path) == ["q.pt"]        # no temporary file left


def test_load_control_lands_on_the_space_or_the_card(tmp_path, monkeypatch):
    from ocean_torch.fem import make_space
    from ocean_torch.mesh import structured
    path = str(tmp_path / "q.pt")
    quad, p2 = _control(2)
    saved = Control(torch.as_tensor(quad), torch.as_tensor(p2))
    torch_ckpt.save_control(path, saved, 0.5, 4)
    space = make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 2,
                                                 2), device="cpu")
    for device in (space.device, "cpu"):
        got, lr, it = torch_ckpt.load_control(path, device=device)
        assert got.quad.device.type == got.p2.device.type == "cpu"
        assert torch.equal(got.quad, saved.quad)
        assert torch.equal(got.p2, saved.p2) and (lr, it) == (0.5, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_ckpt.load_control(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_ckpt.load_control(path, device="cuda")


def test_sync_walks_nested_structures():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), (1, "x")],
            "c": Control(torch.ones(1), torch.ones(1))}
    sync(tree)
    sync(None)
    sync(torch.ones(2))


def test_timer_measures_the_span():
    with Timer() as t:
        time.sleep(0.05)
    assert 0.05 <= t.elapsed < 5.0
