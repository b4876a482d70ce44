"""Port parity for the crossing-classification slice, on the CPU: each of
the seven recurrent classifiers against its JAX counterpart on both JAX
routes (the ``xla`` scan and the ``pallas`` kernels in interpret mode), and
the two GCN classifiers (no kernel), logits and parameter gradients,
through ``import_classification``; the prevalent-class baseline
(``initial_preds`` and its metrics); one
``training_step`` of ``ClassificationFlow`` against the JAX flow's (loss,
gradients, AdamW update) with dropout 0; the metrics against the JAX
package's on seeded logits; dropout; the trainer's metric logging; the CLI.

Bars (``tests/ops/test_pallas_graph_gru.py``): logits atol 1e-5, each
parameter gradient within 1e-4 of its largest magnitude, losses rtol 1e-4.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pedestrians_video_2_carla_tpu.flows.classification import \
    ClassificationFlow as JClassificationFlow
from pedestrians_video_2_carla_tpu.metrics import classification as JM
from pedestrians_video_2_carla_tpu.metrics.base import \
    MetricCollection as JMetricCollection
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.classification import \
    CLASSIFICATION_MODELS as J_MODELS
from pedestrians_video_2_carla_tpu.skeletons.carla import \
    CARLA_SKELETON as J_SKELETON

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
    Carla2D3DDataModule
from pedestrians_video_2_carla_torch.flows.classification import \
    ClassificationFlow
from pedestrians_video_2_carla_torch.metrics import classification as TM
from pedestrians_video_2_carla_torch.metrics.base import (MetricCollection,
                                                          safe_div)
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.classification import \
    CLASSIFICATION_MODELS
from pedestrians_video_2_carla_torch.models.classification import gnn as TG
from pedestrians_video_2_carla_torch.models.classification.common import \
    dropout
from pedestrians_video_2_carla_torch.models.jax_import import (
    import_classification, import_flow_params)
from pedestrians_video_2_carla_torch.models.rnn import HoistedLSTM
from pedestrians_video_2_carla_torch.skeletons.carla import CARLA_SKELETON
from pedestrians_video_2_carla_torch.training.trainer import (Trainer,
                                                              TrainerConfig)
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L, J, H = 6, 5, 26, 16       # as tests/ops/test_pallas_graph_gru.py
LR = 1e-3
LOGIT_ATOL, GRAD_ATOL = 1e-5, 1e-4
#: the JAX route of each of the port's routes
ROUTES = {"plain": "xla", "fused": "pallas"}
#: name -> (constructor arguments of both packages, the route field)
MODELS = {
    "GConvGRU": (dict(hidden_size=H), "graph_kernel"),          # k=2
    "DCRNN": (dict(hidden_size=H), "graph_kernel"),
    "TGCN": (dict(hidden_size=H), "graph_kernel"),              # k=1
    "GConvLSTM": (dict(hidden_size=H), "graph_kernel"),
    "SpatialTemporalGNN": (dict(), "graph_kernel"),             # k=3, H=3
    "LSTM": (dict(hidden_size=H, embeddings_size=12), "rnn_kernel"),
    "GRU": (dict(hidden_size=H), "rnn_kernel"),
}


def _seeded_like(tree, rng):
    """A parameter tree of the same structure with every leaf drawn anew
    (biases as well: flax starts them at zero, which would hide a bias that
    is folded in twice or not at all)."""
    if isinstance(tree, dict):
        return {k: _seeded_like(v, rng) for k, v in sorted(tree.items())}
    a = np.asarray(tree)
    scale = 0.3 if a.ndim == 1 else a.shape[0] ** -0.5
    return (scale * rng.standard_normal(a.shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs and numpy-seeded parameters of one model (shared by routes)."""
    kwargs, field = MODELS[name]
    model = J_MODELS[name](**{field: "xla"}, **kwargs)
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((B, L, J, model.input_features)).astype(
        np.float32)
    tree = jax.device_get(model.init(jax.random.PRNGKey(0), x))["params"]
    return x, _seeded_like(tree, rng)


@functools.lru_cache(maxsize=None)
def _jax_model(name, route):
    """Logits and parameter gradients of sum(sin(logits)) of the JAX model
    on one route."""
    kwargs, field = MODELS[name]
    model = J_MODELS[name](**{field: route}, **kwargs)
    x, params = _case(name)

    def loss(p):
        logits = model.apply({"params": p}, x)
        return jnp.sum(jnp.sin(logits)), logits
    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(logits), jax.device_get(grads)


def _port_model(name, route):
    kwargs, field = MODELS[name]
    model = CLASSIFICATION_MODELS[name](
        generator=torch.Generator().manual_seed(0), **{field: route},
        **kwargs)
    model.load_state_dict(import_classification(_case(name)[1]), strict=True)
    return model


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name, route):
    x, _ = _case(name)
    model = _port_model(name, route)
    logits = model(torch.from_numpy(x))
    ref_logits, ref_grads = _jax_model(name, ROUTES[route])
    assert tuple(logits.shape) == ref_logits.shape == (B, 2)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, rtol=0,
                               atol=LOGIT_ATOL)
    torch.sin(logits).sum().backward()
    ref = import_classification(ref_grads)
    params = dict(model.named_parameters())
    assert set(params) == set(ref)
    for k, p in params.items():
        r = ref[k].numpy()
        scale = float(np.abs(r).max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy() / scale, r / scale, rtol=0,
                                   atol=GRAD_ATOL, err_msg=f"{name}.{k}")


#: the GCN classifiers, and their leaves whose exact gradient is 0: the
#: attention's key bias (the softmax takes it out). Both packages give
#: rounding there (about 1e-9 of the model's largest gradient), so it is
#: held to 1e-6 of that largest gradient on both sides, not to the other
GCN_MODELS = {"GCNBestPaper": set(),
              "GCNBestPaperTransformer": {"Dense_2.bias"}}


@pytest.mark.parametrize("name", list(GCN_MODELS))
def test_gcn_classifier_matches_jax(name):
    """Dropout off (evaluation): logits within 1e-5, each parameter's
    gradient of sum(sin(logits)) within 1e-4 of its largest magnitude
    (``GCN_MODELS`` names the exact zeros)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((B, L, J, 2)).astype(np.float32)
    model = J_MODELS[name]()
    tree = jax.device_get(model.init(jax.random.PRNGKey(0), x))["params"]
    params = _seeded_like(tree, rng)

    def loss(p):
        logits = model.apply({"params": p}, x)
        return jnp.sum(jnp.sin(logits)), logits
    (_, ref_logits), ref_grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    port = CLASSIFICATION_MODELS[name](
        generator=torch.Generator().manual_seed(0))
    assert port.output_type.name == J_MODELS[name]().output_type.name
    port.load_state_dict(import_classification(params), strict=True)
    logits = port(torch.from_numpy(x))
    assert tuple(logits.shape) == (B, 1)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=0,
                               atol=LOGIT_ATOL)
    torch.sin(logits).sum().backward()
    ref = import_classification(jax.device_get(ref_grads))
    named = dict(port.named_parameters())
    assert set(named) == set(ref)
    top = max(float(r.abs().max()) for r in ref.values())
    for k, p in named.items():
        r = ref[k].numpy()
        if k in GCN_MODELS[name]:
            assert max(np.abs(r).max(), p.grad.abs().max()) <= 1e-6 * top
            continue
        scale = float(np.abs(r).max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy() / scale, r / scale,
                                   rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"{name}.{k}")
    # training: dropout from the generator, the same draws the same logits
    a, b = (port(torch.from_numpy(x), training=True,
                 generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, logits)


@pytest.mark.parametrize("name,classes", [("GCNBestPaper", 2),
                                          ("GConvGRU", 2), ("GRU", 3)],
                         ids=["binary", "two_logits", "three_classes"])
def test_baseline_matches_jax(name, classes):
    """The prevalent-class predictions of each batch and the metrics of
    the fit-start pass over them, against the JAX flow's."""
    flow = ClassificationFlow(CLASSIFICATION_MODELS[name](
        num_classes=classes, **({"hidden_size": 4} if name != "GCNBestPaper"
                                else {})), num_classes=classes, device="cpu")
    j_flow = JClassificationFlow(J_MODELS[name](num_classes=classes),
                                 num_classes=classes)
    assert flow.binary == j_flow.binary == (name == "GCNBestPaper")
    rng = np.random.default_rng(11)
    p_state = flow.initial_metrics.init_state("cpu")
    j_state = j_flow.initial_metrics.init_state()
    # label mixes with each class the most frequent once, and a tie
    for probs in ([0.2, 0.7, 0.1], [0.6, 0.3, 0.1], [0.1, 0.1, 0.8],
                  [0.5, 0.5, 0.0]):
        p = np.asarray(probs[:classes]) / np.sum(probs[:classes])
        labels = rng.choice(classes, size=16, p=p).astype(np.int32)
        if probs[2] == 0.0:
            labels = np.repeat(np.arange(2, dtype=np.int32), 8)
        inputs = np.zeros((16, 2, J, 2), np.float32)
        preds = flow.initial_preds(torch.from_numpy(inputs),
                                   {"crossing": torch.from_numpy(labels)})
        ref = j_flow.initial_preds(jnp.asarray(inputs),
                                   {"crossing": jnp.asarray(labels)})
        np.testing.assert_array_equal(preds["crossing_logits"].numpy(),
                                      np.asarray(ref["crossing_logits"]))
        p_state = flow.initial_metrics.update(
            p_state, preds, {"crossing": torch.from_numpy(labels)})
        j_state = j_flow.initial_metrics.update(
            j_state, ref, {"crossing": jnp.asarray(labels)})
    assert flow.initial_preds(None, {}) == j_flow.initial_preds(None, {}) \
        == {}
    got = flow.initial_metrics.compute(p_state)
    want = j_flow.initial_metrics.compute(j_state)
    assert set(got) == set(want)
    for metric, w in want.items():
        pairs = [(got[metric][k], w[k]) for k in w] if isinstance(w, dict) \
            else [(got[metric], w)]
        for g, r in pairs:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7, err_msg=metric)


@pytest.mark.parametrize("name,entry,calls", [
    ("GConvGRU", "graph_gru_scan", 2), ("TGCN", "graph_gru_scan", 2),
    ("SpatialTemporalGNN", "graph_gru_scan", 1),
    ("GConvLSTM", "graph_lstm_scan", 2)])
def test_fused_route_takes_the_scan_entry(name, entry, calls, monkeypatch):
    """graph_kernel="fused" must reach the scan entry (one per layer) and
    "plain" must not: a quiet fall back would make the parity tests vacuous."""
    seen = []
    orig = getattr(TG, entry)
    monkeypatch.setattr(TG, entry, lambda *a, **k: (seen.append(1),
                                                    orig(*a, **k))[1])
    x = torch.from_numpy(_case(name)[0])
    _port_model(name, "fused")(x)
    assert len(seen) == calls
    _port_model(name, "plain")(x)
    _port_model(name, "auto")(x)        # on CPU tensors auto is plain
    assert len(seen) == calls


def _plan_stub(size, refuse):
    """A launch-plan function of ``size`` numbers that gives zeros for the
    passes in ``refuse`` ("fwd", "bwd") and ones otherwise."""
    def plan(B, J, H, k, backward=False, device=None):
        return (0,) * size if ("bwd" if backward else "fwd") in refuse \
            else (1,) * size
    return plan


def _dense_plan_stub(refuse):
    """dense_lstm_plan's six numbers: the forward's three, the backward's."""
    def plan(B, J, H, k=1, device=None):
        return tuple(0 if p in refuse else 1 for p in ("fwd",) * 3
                     + ("bwd",) * 3)
    return plan


@pytest.mark.parametrize("name,k,plans", [
    ("GConvGRU", 2, ("graph_gru_plan",)),
    ("GConvLSTM", 2, ("graph_lstm_plan",)),
    ("GConvLSTM", 1, ("dense_lstm_plan", "graph_lstm_plan"))])
def test_auto_route_follows_the_launch_plans(name, k, plans, monkeypatch):
    """On the card, "auto" takes the scan kernels only where the launch
    plans take the layer's shape (the forward's, and the backward's when a
    gradient will be taken), and "fused" raises where they do not; the
    choice is made from the plans alone (stubbed here, with the card's test
    forced true on CPU tensors, where the entries run their plain
    versions)."""
    entry = "graph_lstm_scan" if name == "GConvLSTM" else "graph_gru_scan"
    seen, asked = [], []
    orig = getattr(TG, entry)
    monkeypatch.setattr(TG, entry, lambda *a, **kw: (seen.append(1),
                                                     orig(*a, **kw))[1])
    monkeypatch.setattr(TG, "_on_card", lambda x: True)
    x = torch.from_numpy(_case("GConvGRU")[0])

    def model(route):
        return CLASSIFICATION_MODELS[name](
            hidden_size=32, k=k, graph_kernel=route,
            generator=torch.Generator().manual_seed(0))

    def stub(refuse, dense_refuse=("fwd", "bwd")):
        seen.clear()
        for plan in plans:
            if plan == "dense_lstm_plan":
                fn = _dense_plan_stub(dense_refuse)
            else:
                fn = _plan_stub(4 if "lstm" in plan else 3, refuse)
            monkeypatch.setattr(TG, plan, lambda *a, fn=fn, plan=plan, **kw:
                                (asked.append(plan), fn(*a, **kw))[1])

    stub(())                            # the plans take both passes
    model("auto")(x).sum().backward()
    assert len(seen) == 2
    stub(("bwd",))                      # the reverse scan does not fit
    model("auto")(x).sum().backward()
    assert len(seen) == 0
    with torch.no_grad():               # serving needs the forward alone
        model("auto")(x)
    assert len(seen) == 2
    with pytest.raises(ValueError, match="launch plan zero"):
        model("fused")(x)
    stub(("fwd", "bwd"))
    with torch.no_grad():
        model("auto")(x)
        with pytest.raises(ValueError, match="launch plan zero"):
            model("fused")(x)
    assert len(seen) == 0
    assert set(asked) == set(plans)
    if "dense_lstm_plan" in plans:      # k = 1: the dense route's plan rules
        stub(("fwd", "bwd"), dense_refuse=())
        model("auto")(x).sum().backward()
        assert len(seen) == 2
        stub((), dense_refuse=("bwd",))
        model("auto")(x).sum().backward()
        assert len(seen) == 0
    model("plain")(x)
    assert len(seen) == 0


def test_lstm_classifier_fused_route_is_the_dense_scan(monkeypatch):
    from pedestrians_video_2_carla_torch.models import rnn as TR
    seen = []
    orig = TR.graph_lstm_scan

    def probe(xg, cheb, w, with_c=False):
        seen.append((tuple(xg.shape), tuple(cheb.shape), with_c))
        return orig(xg, cheb, w, with_c=with_c)
    monkeypatch.setattr(TR, "graph_lstm_scan", probe)
    x = torch.from_numpy(_case("LSTM")[0])
    _port_model("LSTM", "fused")(x)
    assert seen == [((L, B, 1, 4 * H), (0, 1, 1), True)] * 2
    _port_model("LSTM", "auto")(x)      # auto keeps the loop, as JAX does
    assert len(seen) == 2


def test_hoisted_lstm_carry_order_and_reverse():
    """(c, h) carry order; with ``reverse`` the outputs stay in processing
    order; the fused route returns the same; an explicit carry takes the
    loop."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 4, 7, generator=g)
    bias = torch.randn(5, generator=g)
    outs = {}
    for kernel in ("plain", "fused"):
        layer = HoistedLSTM(7, 5, reverse=True, kernel=kernel,
                            generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            layer.hi.bias.copy_(bias)
        (c, h), ys = layer(x)
        assert torch.allclose(h, ys[:, -1]) and not torch.allclose(c, h)
        outs[kernel] = (c, h, ys)
    for a, b in zip(outs["plain"], outs["fused"]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)
    forward = HoistedLSTM(7, 5, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        forward.hi.bias.copy_(bias)
    _, ys_f = forward(x.flip(1))
    np.testing.assert_allclose(ys_f.detach().numpy(),
                               outs["plain"][2].detach().numpy(), atol=1e-6)
    carry = (torch.ones(3, 5), torch.zeros(3, 5))
    (c1, _), _ = HoistedLSTM(7, 5, kernel="fused")(x, initial_carry=carry)
    assert c1.shape == (3, 5)


def test_model_fields_and_jax_names_are_refused():
    with pytest.raises(ValueError, match="plain"):
        CLASSIFICATION_MODELS["GConvGRU"](graph_kernel="pallas")
    with pytest.raises(ValueError, match="plain"):
        CLASSIFICATION_MODELS["LSTM"](rnn_kernel="xla")
    with pytest.raises(ValueError, match="unknown"):
        CLASSIFICATION_MODELS["TGCN"](graph_kernel="triton")
    assert set(J_MODELS) == set(CLASSIFICATION_MODELS)  # all nine ported
    st = CLASSIFICATION_MODELS["SpatialTemporalGNN"]()
    assert (st.hidden_size, st.k, st.input_features, st.needs_confidence) \
        == (3, 3, 3, True)
    assert CLASSIFICATION_MODELS["TGCN"]().k == 1
    gru = CLASSIFICATION_MODELS["GConvGRU"]()
    assert (gru.hidden_size, gru.k, gru.p_dropout, gru.graph_kernel) \
        == (128, 2, 0.2, "auto")


def test_skeleton_graph_matches_jax():
    np.testing.assert_array_equal(CARLA_SKELETON.get_edge_index(),
                                  J_SKELETON.get_edge_index())
    for normalized in (True, False):
        for loops in (True, False):
            np.testing.assert_array_equal(
                CARLA_SKELETON.get_adjacency_matrix(normalized, loops),
                J_SKELETON.get_adjacency_matrix(normalized, loops))
    # DCRNN / TGCN: normalized adjacency with self loops; GConvGRU: the
    # operator -D^-1/2 A D^-1/2 without
    assert np.all(np.diag(TG.normalized_adjacency(CARLA_SKELETON)) > 0)
    assert np.all(np.diag(TG.laplacian_op(CARLA_SKELETON)) == 0)
    assert TG.laplacian_op(CARLA_SKELETON).max() <= 0


def test_seeded_init_is_reproducible_and_in_flax_families():
    a, b = (CLASSIFICATION_MODELS["GConvGRU"](
        hidden_size=64, generator=torch.Generator().manual_seed(7))
        for _ in range(2))
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k
        if p.ndim == 1:
            assert not p.any()
    w = a.rnn2_z_wh0                      # lecun normal: variance 1 / fan_in
    assert abs(float(w.detach().std()) - 64 ** -0.5) < 0.02
    assert float(w.detach().abs().max()) <= 2 * 64 ** -0.5 / .87962566 + 1e-6
    lstm = CLASSIFICATION_MODELS["LSTM"](
        hidden_size=8, generator=torch.Generator().manual_seed(7))
    hh = lstm.OptimizedLSTMCell_0.hi.weight
    np.testing.assert_allclose((hh @ hh.t()).detach().numpy(), np.eye(8),
                               atol=1e-5)                # orthogonal


def test_dropout_draws_from_the_generator():
    x = torch.ones(2000)
    g = torch.Generator().manual_seed(5)
    a = dropout(x, 0.25, True, g)
    b = dropout(x, 0.25, True, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert a.unique().tolist() == pytest.approx([0.0, 1.0 / 0.75])
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.05
    assert dropout(x, 0.25, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.25, True, None)


# -- the flow ------------------------------------------------------------------
def _batch(rng):
    inputs = rng.standard_normal((B, L, J, 2)).astype(np.float32)
    labels = rng.integers(0, 2, size=B).astype(np.int32)
    return inputs, {"crossing": labels}, {}


@functools.lru_cache(maxsize=None)
def _jax_step_case(route):
    """A JAX ClassificationFlow (GConvGRU, dropout 0), numpy-seeded params,
    a batch, and the body of its ``training_step``, keeping the gradients."""
    rng = np.random.default_rng(17)
    batch = _batch(rng)
    flow = JClassificationFlow(
        classification_model=J_MODELS["GConvGRU"](
            hidden_size=H, p_dropout=0.0, graph_kernel=route),
        classification_optimizer=JOptimizerSettings(lr=LR))
    state = flow.init_state(jax.random.PRNGKey(1), batch)
    params = _seeded_like(jax.device_get(state.params), rng)
    opt_state = flow._tx.init(params)

    def loss_fn(p):
        logits, _ = flow._apply(p, state.mutables, batch[0], True,
                                {"dropout": jax.random.PRNGKey(2)})
        return flow._loss(logits, batch[1])
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = flow._tx.update(grads, opt_state, params, value=loss)
    new_params = optax.apply_updates(params, updates)
    eval_losses, preds, _ = flow.eval_step(state.replace(params=params),
                                           batch)
    return jax.device_get((params, batch, grads, new_params, loss,
                           eval_losses, preds))


def _port_flow(route, **kwargs):
    model = CLASSIFICATION_MODELS["GConvGRU"](
        hidden_size=H, p_dropout=0.0, graph_kernel=route,
        generator=torch.Generator().manual_seed(0))
    return ClassificationFlow(
        model, classification_optimizer=OptimizerSettings(lr=LR),
        device="cpu", **kwargs)


def _to_torch(batch):
    inputs, targets, meta = batch
    return (torch.from_numpy(np.asarray(inputs)),
            {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()},
            meta)


@pytest.mark.parametrize("route", list(ROUTES))
def test_training_step_matches_jax(route):
    j_params, j_batch, j_grads, j_new, j_loss, j_eval, j_preds = \
        _jax_step_case(ROUTES[route])
    flow = _port_flow(route)
    params = import_flow_params(j_params, device="cpu")
    assert set(params) == {"classification"}
    batch = _to_torch(j_batch)

    losses, preds, targets = flow.eval_step(params, batch)
    assert set(losses) == {"classification", "primary"}
    np.testing.assert_allclose(float(losses["primary"]),
                               float(j_eval["primary"]), rtol=1e-4)
    np.testing.assert_allclose(preds["crossing_logits"].numpy(),
                               j_preds["crossing_logits"], atol=LOGIT_ATOL)
    assert targets is batch[1]

    state = flow.init_state(params)
    state, logs = flow.training_step(state, batch)
    assert state.step == 1 and set(logs) == {"train_loss/primary"}
    np.testing.assert_allclose(float(logs["train_loss/primary"]),
                               float(j_loss), rtol=1e-4)
    ref_grads = import_classification(j_grads["classification"])
    ref_new = import_classification(j_new["classification"])
    tree = state.params["classification"]
    assert set(tree) == set(ref_grads)
    for k, p in tree.items():
        g_ref = ref_grads[k].numpy()
        scale = float(np.abs(g_ref).max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy() / scale, g_ref / scale,
                                   rtol=0, atol=GRAD_ATOL, err_msg=k)
        # Adam's first step is about lr * sign(g): where g is tiny against
        # the leaf's largest, rounding can flip its sign between the
        # frameworks, and the new params differ by up to 2 lr
        diff = np.abs(p.detach().numpy() - ref_new[k].numpy())
        big = np.abs(g_ref) > 1e-3 * np.abs(g_ref).max()
        assert diff[big].max(initial=0.0) <= 2e-5, k
        assert diff[~big].max(initial=0.0) <= 2 * LR + 1e-6, k
    assert flow.current_lrs(state) == {"lr-classification": LR}
    assert flow.param_counts(state) == {
        "classification": sum(v.numel() for v in tree.values())}


def test_flow_defaults_loss_and_refusals():
    flow = ClassificationFlow(device="cpu")
    assert type(flow.classification_model).__name__ == "LSTM"
    assert flow.outputs_key == "crossing_logits" and not flow.binary
    logits = torch.tensor([[2.0, -1.0], [0.5, 0.25]])
    labels = {"crossing": torch.tensor([0, 1], dtype=torch.int32)}
    ref = float(optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits.numpy()), jnp.asarray([0, 1])).mean())
    np.testing.assert_allclose(float(flow._loss(logits, labels)), ref,
                               rtol=1e-6)
    flow.binary = True                  # a binary-output model's loss
    one = torch.tensor([[1.5], [-0.5]])
    ref = float(optax.sigmoid_binary_cross_entropy(
        jnp.asarray([1.5, -0.5]), jnp.asarray([0.0, 1.0])).mean())
    np.testing.assert_allclose(float(flow._loss(one, labels)), ref, rtol=1e-6)
    # bf16 is ported ("16" is bf16, as in the JAX package); other
    # precisions are refused
    for precision in ("bf16", "16"):
        assert ClassificationFlow(device="cpu",
                                  precision=precision).precision == "bf16"
    with pytest.raises(ValueError, match="precision"):
        ClassificationFlow(device="cpu", precision="64")
    # clipping and the LR schedules are ported (held against optax in
    # tests/test_torch_train_options.py)
    scheduled = ClassificationFlow(
        device="cpu", gradient_clip_val=1.0,
        classification_optimizer=OptimizerSettings(
            enable_lr_scheduler=True))
    assert scheduled.gradient_clip_val == 1.0
    assert list(scheduled.init_state().schedules) == ["classification"]
    benchmark = ClassificationFlow(device="cpu",
                                   classification_average="benchmark")
    assert benchmark.average["Accuracy"] == "micro"
    assert set(ClassificationFlow(device="cpu", num_classes=3).get_metrics()) \
        == {"Accuracy", "Precision", "Recall", "F1Score", "ConfusionMatrix"}


def test_training_with_dropout_is_seeded_and_differs_from_eval():
    def run(seed):
        model = CLASSIFICATION_MODELS["GConvGRU"](
            hidden_size=H, p_dropout=0.5, graph_kernel="fused",
            generator=torch.Generator().manual_seed(0))
        flow = ClassificationFlow(model, device="cpu", seed=seed)
        batch = _to_torch(_batch(np.random.default_rng(2)))
        state = flow.init_state()
        _, logs = flow.training_step(state, batch)
        return float(logs["train_loss/primary"]), float(
            flow.eval_step(flow.init_params(), batch)[0]["primary"])
    (a, eval_a), (b, _), (c, _) = run(1), run(1), run(2)
    assert a == b and a != c and a != eval_a


# -- the metrics ---------------------------------------------------------------
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("shape", ["two_logits", "one_logit", "three_classes"])
def test_metrics_match_jax(average, shape):
    rng = np.random.default_rng(23)
    classes = 3 if shape == "three_classes" else 2
    binary = shape == "one_logit"
    kw = dict(num_classes=classes, binary=binary)
    names = {"Accuracy": "Accuracy", "Precision": "Precision",
             "Recall": "Recall", "F1Score": "F1Score"}
    port = {n: getattr(TM, c)(average=average, **kw) for n, c in names.items()}
    ref = {n: getattr(JM, c)(average=average, **kw) for n, c in names.items()}
    port["ConfusionMatrix"] = TM.ConfusionMatrixMetric(**kw)
    ref["ConfusionMatrix"] = JM.ConfusionMatrixMetric(**kw)
    if classes == 2:
        for n, c in (("AUROC", "AUROC"), ("ROC", "ROCCurve"),
                     ("PRCurve", "PRCurve")):
            port[n] = getattr(TM, c)(binary=binary)
            ref[n] = getattr(JM, c)(binary=binary)
    port, ref = MetricCollection(port), JMetricCollection(ref)
    p_state, r_state = port.init_state("cpu"), ref.init_state()
    for _ in range(3):                    # states add up over batches
        logits = rng.standard_normal((40, 1 if binary else classes)).astype(
            np.float32) * 2
        labels = rng.integers(0, classes, size=40).astype(np.int32)
        p_state = port.update(p_state,
                              {"crossing_logits": torch.from_numpy(logits)},
                              {"crossing": torch.from_numpy(labels)})
        r_state = ref.update(r_state, {"crossing_logits": jnp.asarray(logits)},
                             {"crossing": jnp.asarray(labels)})
    got, want = port.compute(p_state), ref.compute(r_state)
    assert set(got) == set(want)
    for name, w in want.items():
        if isinstance(w, dict):
            assert set(got[name]) == set(w)
            pairs = [(got[name][k], w[k]) for k in w]
        else:
            pairs = [(got[name], w)]
        for g, r in pairs:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    # a batch without the keys leaves the state as it was
    same = port.update(p_state, {}, {})
    assert all(torch.equal(same[n][k], v) for n, tree in p_state.items()
               for k, v in tree.items())


def test_safe_div():
    out = safe_div(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.5, 0.0, -1.0]))
    assert out.tolist() == [2.0, 0.0, 0.0]


# -- trainer and CLI -----------------------------------------------------------
def test_trainer_logs_metrics_and_checkpoints_on_primary(tmp_path):
    flow = _port_flow("fused")
    dm = Carla2D3DDataModule(batch_size=4, clip_length=L, val_set_size=8,
                             test_set_size=8, device="cpu")
    trainer = Trainer(flow, dm, TrainerConfig(
        max_epochs=2, limit_train_batches=2, log_every_n_steps=1,
        logs_dir=str(tmp_path), run_name="cls", device="cpu"))
    state = trainer.fit()
    assert state.step == 4
    with open(tmp_path / "cls" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if "epoch" in r]
    assert len(epochs) == 2
    last = epochs[-1]
    assert last["val_loss/primary"] == last["val_loss/classification"]
    for k in ("val_Accuracy", "val_Precision", "val_Recall", "val_F1Score",
              "val_AUROC"):
        assert 0.0 <= last[k] <= 1.0
    assert np.sum(last["val_ConfusionMatrix"]) == 8
    assert len(last["val_ROC/fpr"]) == len(last["val_PRCurve/recall"]) == 127
    ckpts = tmp_path / "cls" / "checkpoints"
    with open(ckpts / "best.json") as f:
        best = json.load(f)
    assert best["val_loss/primary"] == min(e["val_loss/primary"]
                                           for e in epochs)
    assert os.path.exists(ckpts / "last.pt")
    restored = flow.init_state()
    trainer.checkpoints.restore(restored, str(ckpts / "last"))
    assert restored.step == 4
    for k, v in state.params["classification"].items():
        assert torch.equal(restored.params["classification"][k], v)
    test = trainer.test()
    assert "test_loss/primary" in test and "test_Accuracy" in test


@pytest.mark.parametrize("flags", [
    ["--classification_model_name=GConvGRU", "--hidden_size=16",
     "--graph_kernel=fused"],
    ["--classification_model_name=SpatialTemporalGNN"],
    ["--rnn_kernel=fused", "--hidden_size=8"]],
    ids=["GConvGRU", "SpatialTemporalGNN", "LSTM_default"])
def test_cli_trains_a_classifier_on_the_cpu(tmp_path, flags):
    results = modeling.main([
        "--flow=classification", *flags, "--batch_size=4", "--clip_length=5",
        "--max_epochs=1", "--limit_train_batches=3", "--val_set_size=8",
        "--log_every_n_steps=1", "--classification_lr=1e-3", "--device=cpu",
        f"--root_dir={tmp_path}", "--run_name=cli"])
    run = tmp_path / "logs" / "classification" / "cli"
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "lr-classification" in r]
    assert len(steps) == 3
    assert all(np.isfinite(r["train_loss/primary"]) for r in steps)
    assert steps[0]["lr-classification"] == 1e-3
    assert os.path.exists(run / "checkpoints" / "last.pt")
    assert np.isfinite(results["val_metrics"]["val_loss/primary"])
    assert "val_Accuracy" in results["val_metrics"]
    # test mode evaluates the checkpoint
    tested = modeling.main([
        "--flow=classification", *flags, "--mode=test", "--batch_size=4",
        "--clip_length=5", "--test_set_size=8", "--device=cpu",
        f"--ckpt_path={run / 'checkpoints' / 'last'}",
        f"--root_dir={tmp_path}", "--run_name=cli_test"])
    assert np.isfinite(tested["test_metrics"]["test_loss/primary"])


@pytest.mark.parametrize("flag", ["--data_module_name=CarlaRecordedVideo",
                                  "--data_module_name=AMASS",
                                  "--data_module_name=MPII"])
def test_cli_names_what_is_not_ported(flag, tmp_path):
    """CarlaRecordedVideo feeds the pose-estimation flow alone: a
    classifier is refused its frames. AMASS and MPII are ported and carry
    no crossing label: on synthetic files the classification flow fails at
    its first step in both CLIs alike, looking up ``crossing``."""
    argv = ["--flow=classification", flag, "--device=cpu",
            f"--root_dir={tmp_path}"]
    if flag.endswith("CarlaRecordedVideo"):
        with pytest.raises(ValueError, match="video data module"):
            modeling.main(argv)
    else:
        from pedestrians_video_2_carla_tpu import modeling as jmodeling
        from tests.test_torch_amass_mpii_mixed import (write_mocaps,
                                                       write_mpii)
        write_mocaps(tmp_path / "datasets", frames=40)
        write_mpii(tmp_path / "datasets")
        common = ["--flow=classification", flag,
                  f"--datasets_dir={tmp_path / 'datasets'}",
                  "--classification_model_name=GConvGRU", "--hidden_size=8",
                  "--batch_size=2", "--clip_length=3", "--max_epochs=1",
                  "--limit_train_batches=1", "--renderers", "none"]
        for side, main, extra in (
                ("port", modeling.main, ["--device=cpu"]),
                ("jax", jmodeling.main, [])):
            with pytest.raises(KeyError, match="crossing"):
                main(common + extra + [
                    f"--root_dir={tmp_path / side}",
                    f"--outputs_dir={tmp_path / side / 'outputs'}"])
