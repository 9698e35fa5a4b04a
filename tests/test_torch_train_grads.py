"""repro_torch's training objective and gradients vs the JAX package, on
the CPU, for each of the ten smoke configs of ``list_archs()``.

The JAX ``init_params(cfg, 0)`` tree is carried into the port's model
(``convert.lm_params_from_reference``), both packages take the same
batch (tokens, labels, and the stub frames or patches), and the port's
``model.loss`` and its gradients are held to JAX ``value_and_grad(
model.loss)``: the loss within rel 1e-5, every parameter's gradient
within rel max-abs 1e-4 (mapped by name with ``convert.tree_by_name``).
The loss at init lies in (0.5 ln V, 2 ln V) (``tests/test_models_smoke.
py``); rematerialized layers (``remat=True``, both policies) give the
same loss and gradients within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro.models import build_model as j_build

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import build_model

ARCHS = jconfigs.list_archs()
SHAPE = ("smoke", "train", 16, 2)     # tests/test_models_smoke.py SHAPE
LOSS_BAR = 1e-5                       # rel
GRAD_BAR = 1e-4                       # rel max-abs, per parameter
REMAT_BAR = 1e-6


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if np.issubdtype(np.asarray(v).dtype, np.integer)
        else np.float32)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One smoke config: JAX's loss and gradients by the port's names
    (computed once), and the port's model carrying JAX's parameters,
    with gradients on."""
    arch = request.param
    jm = j_build(jconfigs.get_smoke_config(arch))
    jp = jm.init(0)
    batch = jm.dummy_batch(jconfigs.ShapeConfig(*SHAPE))
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, batch)
    cfg = tconfigs.get_smoke_config(arch)
    model = convert.lm_params_from_reference(
        build_model(cfg, device="cpu"),
        jax.tree_util.tree_map(np.asarray, jp))
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return dict(arch=arch, cfg=cfg, model=model, params=params,
                batch=_torch_batch(batch), jloss=float(jloss),
                jgrads=convert.tree_by_name(
                    jax.tree_util.tree_map(np.asarray, jgrads)))


def _loss_and_grads(case, cfg):
    model, params = case["model"], case["params"]
    model.cfg = cfg
    try:
        loss = model.loss(case["batch"])
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        model.cfg = case["cfg"]
    return float(loss.detach()), dict(zip(params, grads))


def test_loss_and_grads_match_jax(case):
    loss, grads = _loss_and_grads(case, case["cfg"])
    assert abs(loss - case["jloss"]) <= LOSS_BAR * abs(case["jloss"])
    V = case["cfg"].vocab_size
    assert 0.5 * np.log(V) < loss < 2.0 * np.log(V)
    assert set(grads) == set(case["jgrads"])
    for name, g in grads.items():
        want = case["jgrads"][name]
        assert tuple(g.shape) == want.shape, name
        assert bool(torch.isfinite(g).all()), name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_BAR * scale, (name, err, scale)
    assert any(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_matches_plain(case, policy):
    loss, grads = _loss_and_grads(case, case["cfg"])
    rloss, rgrads = _loss_and_grads(
        case, dataclasses.replace(case["cfg"], remat=True,
                                  remat_policy=policy))
    assert abs(rloss - loss) <= REMAT_BAR * abs(loss)
    for name, g in grads.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((rgrads[name] - g).abs().max()) <= REMAT_BAR * scale, \
            name
