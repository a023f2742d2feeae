"""What the perception trainers' tests (``tests/test_torch_train_*.py``)
share: the tolerances they hold the port to, and running a training script
of each package on the same arguments."""

import logging

import numpy as np
import pytest
import torch

GRAD_TOL = 1e-5      # first-step gradients: relative L2 per tensor
WEIGHT_TOL = 1e-5    # weights after three steps: absolute, f32
KEY_BIASES = ("k_proj.bias", "key.bias")
MOVE_TOL = 1e-4      # displacement from the initial weights: relative L2
OFF_SHARE = 1e-3     # of a tensor's weights that may pass WEIGHT_TOL (each within lr)
ILL_OFF_SHARE = 1e-2  # the same, for a tensor named ill-conditioned


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jit_init(module, seed: int, *args):
    """JAX's ``module.init`` from ``PRNGKey(seed)``, jitted: the same draws
    as the eager call, which runs the model op by op several times
    slower."""
    import jax

    return jax.jit(module.init)(jax.random.PRNGKey(seed), *args)


def jit_module_inits(monkeypatch, *modules) -> None:
    """JAX's scripts initialise their models eagerly, op by op (21 s of
    the segmenter script's run here, each op compiled alone): make each
    Flax module class's ``init`` a jitted call (the same draws)."""
    import flax.linen as nn
    import jax

    def init(self, rngs, *args, **kw):
        return jax.jit(lambda r, *a: nn.Module.init(self, r, *a, **kw))(rngs, *args)

    for module in modules:
        monkeypatch.setattr(module, "init", init)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _numpy(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def assert_grads_close(model: torch.nn.Module, want: dict, tol: float = GRAD_TOL) -> None:
    """Every parameter's gradient within ``tol`` (relative L2) of ``want``
    (the JAX gradients in the port's layout), the norm it is relative to
    floored at a thousandth of the whole gradient's: a gradient that
    cancels down to ~1e-5 of the whole (a self-attention over the
    segmenter's nearly equal initial queries, whose softmax is nearly
    uniform) is held to 1e-8 of the whole.  An attention's key bias has a
    gradient that is zero but for rounding (the softmax does not see a
    shift of a whole row of scores): both packages' must be within 1e-6 of
    the whole gradient's norm of each other."""
    params = dict(model.named_parameters())
    assert params.keys() == want.keys()
    total = np.sqrt(sum(float(np.sum(_numpy(w).astype(np.float64) ** 2))
                        for w in want.values()))
    for name, p in params.items():
        w = _numpy(want[name]).astype(np.float64)
        g = np.zeros_like(w) if p.grad is None else _numpy(p.grad).astype(np.float64)
        if name.endswith(KEY_BIASES):
            assert np.linalg.norm(g - w) <= 1e-6 * total, name
            continue
        scale = max(float(np.linalg.norm(w)), 1e-3 * total)
        err = float(np.linalg.norm(g - w)) / scale
        assert err <= tol, (name, err)


def assert_trained_close(got: dict, want: dict, init: dict, lr: float, steps: int = 3,
                         ill_conditioned: tuple = ()) -> None:
    """Weights after the trainers' steps: within ``WEIGHT_TOL`` of JAX's, and
    the model's displacement from ``init`` within ``MOVE_TOL`` of JAX's
    (relative L2 over every tensor held to ``WEIGHT_TOL``).

    Adam divides each gradient by its own running size, so a weight whose
    gradient is ill-conditioned turns the packages' rounding into updates
    of up to the learning rate: at most ``OFF_SHARE`` of a tensor's weights
    may pass ``WEIGHT_TOL`` (one of 1152 in the OCR recognizer's second
    convolution, 2.4e-5 after three steps at lr 1e-3), each by less than
    ``lr``, and are left out of the displacement's error; tensors named in
    ``ill_conditioned`` (prefixes) may have ``ILL_OFF_SHARE`` past it and
    are left out of the displacement (the segmenter's decoder
    self-attention over nearly equal initial queries: 9 of 4096 weights of
    a key projection, up to 2.4e-5).  An attention's key bias has a
    gradient that is zero but for rounding, so it moves by up to the
    learning rate a step in either package in the directions of their
    rounding: it is held to ``2 * steps * lr`` of JAX's."""
    assert got.keys() == want.keys()
    sq_err = sq_move = 0.0
    for name in got:
        a, b, c = _numpy(got[name]), _numpy(want[name]), _numpy(init[name])
        assert a.shape == b.shape, name
        if name.endswith(KEY_BIASES):
            assert np.abs(a - b).max() <= 2 * steps * lr, name
            continue
        ill = name.startswith(tuple(ill_conditioned))
        off = np.abs(a - b) > WEIGHT_TOL
        assert off.sum() <= (ILL_OFF_SHARE if ill else OFF_SHARE) * off.size, (
            name, int(off.sum()), off.size)
        assert np.abs(a - b).max() <= lr, (name, np.abs(a - b).max())
        if not ill:
            keep = ~off
            sq_err += float(np.sum((a[keep].astype(np.float64) - b[keep]) ** 2))
            sq_move += float(np.sum((b[keep].astype(np.float64) - c[keep]) ** 2))
    assert sq_move > 0 and np.sqrt(sq_err / sq_move) <= MOVE_TOL, np.sqrt(sq_err / sq_move)


def assert_served_close(got, want, share: float = WEIGHT_TOL) -> None:
    """A served output within ``share`` of its largest magnitude (at least
    1) of JAX's."""
    a, b = _numpy(got), _numpy(want)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= share * max(1.0, float(np.abs(b).max()))


def run_scripts(jax_main, port_main, args: list, tmp_path, caplog, out_flag: str,
                out_name: str) -> tuple[list, list]:
    """JAX's script, then the port's (``--device cpu``), on ``args``, each
    writing ``tmp_path/{jax,port}/out_name``; returns the messages each
    logged."""
    (tmp_path / "jax").mkdir(exist_ok=True)
    (tmp_path / "port").mkdir(exist_ok=True)
    with caplog.at_level(logging.INFO):
        assert jax_main(args + [out_flag, str(tmp_path / "jax" / out_name)]) == 0
        jax_lines = list(caplog.messages)
        caplog.clear()
        assert port_main(args + [out_flag, str(tmp_path / "port" / out_name),
                                 "--device", "cpu"]) == 0
        port_lines = list(caplog.messages)
    return jax_lines, port_lines


def matching(lines: list, text: str) -> list:
    return [line for line in lines if text in line]
