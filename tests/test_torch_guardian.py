"""The PyTorch port's training guardian (deeplearning4j_tpu_torch/
optimize/guardian.py, wired into MultiLayerNetwork.fit / fit_scan) held
against the JAX package's.

On the same fault schedule (NaN features, inf labels, persistent NaNs)
from the same parameters, the port and the JAX package give the same
guardian events at the same steps, the same skip counts, lr scale and
abort report, and params within 2e-5 (float32, summation order). The
reference's two guardian contracts hold bit for bit in the port: with
no fault a guarded run equals the unguarded one, in `fit` and in
`fit_scan`. Then preemption (a committed checkpoint; a real SIGTERM,
the previous handler restored), a twice-preempted resume equal to the
uninterrupted run, the autosave cursors against the JAX package's,
`DeviceFeed.fast_forward` / `cursor` and Iris against the JAX package's.
"""

from __future__ import annotations

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIter
from deeplearning4j_tpu.datasets import device_feed as jfeed
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iris import IrisDataSetIterator as JIris
from deeplearning4j_tpu.datasets.iris import load_iris as jload_iris
from deeplearning4j_tpu.nn import preprocessors as jax_pp
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import guardian as jguardian
from deeplearning4j_tpu.optimize.listeners import \
    CollectGuardianEvents as JCollect
from deeplearning4j_tpu.scaleout.checkpoint import DefaultModelSaver as JDefault
from deeplearning4j_tpu.scaleout.checkpoint import load_checkpoint as jload
from deeplearning4j_tpu_torch.checkpoint import (ShardedModelSaver,
                                                 latest_step,
                                                 restore_network)
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets import (DataSet, DeviceFeed,
                                               IrisDataSetIterator,
                                               ListDataSetIterator,
                                               load_iris)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import guardian
from deeplearning4j_tpu_torch.optimize.guardian import (GuardianAbort,
                                                        GuardianPolicy,
                                                        GuardianSession,
                                                        TrainingPreempted)
from deeplearning4j_tpu_torch.optimize.listeners import CollectGuardianEvents
from deeplearning4j_tpu_torch.scaleout.checkpoint import (DefaultModelSaver,
                                                          load_checkpoint)
from deeplearning4j_tpu_torch.weights import multilayer_params_from_jax

PARAM_TOL = 2e-5
BS = 24


# ------------------------------------------------------------- the nets
def _iris_conf(builder=JConf.builder, algo="iteration_gradient_descent"):
    """tests/test_guardian.py's MLP: 4-8-3 tanh, SGD + momentum 0.5."""
    return (builder().lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo(algo).num_iterations(1)
            .use_adagrad(False).momentum(0.5)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


def _attention_conf():
    """A row-sequence stack over the 4 iris features: reshape to 2 x 2,
    self_attention 2 -> 8 -> 2 (2 heads), flatten, softmax output."""
    return (JConf.builder().lr(0.05).use_adagrad(False).momentum(0.5)
            .num_iterations(1).list(2)
            .override(0, layer="self_attention", n_in=2, n_out=8,
                      n_heads=2)
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_in=4, n_out=3)
            .input_preprocessor(0, jax_pp.ReshapePreProcessor([2, 2]))
            .input_preprocessor(1, jax_pp.ConvolutionPostProcessor())
            .pretrain(False).build())


CONFS = {"mlp": _iris_conf, "attention": _attention_conf}


def _pair(stack="mlp"):
    """(port net, JAX net) on the JAX net's initial parameters."""
    conf = CONFS[stack]()
    jnet = JNet(JMLC.from_json(conf.to_json()))
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.param_table = multilayer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet._params), device="cpu")
    return net, jnet


def _net(stack="mlp"):
    return _pair(stack)[0]


def _stream(n_batches=10, seed=0):
    """tests/test_guardian.py's stream: `n_batches` iris samples of 24
    rows, concatenated."""
    data = load_iris()
    x, y = np.asarray(data.features), np.asarray(data.labels)
    rng = np.random.RandomState(seed)
    idx = np.concatenate([rng.choice(len(x), BS, replace=False)
                          for _ in range(n_batches)])
    return x[idx].copy(), y[idx].copy()


def _params(net) -> np.ndarray:
    return net.params().detach().cpu().numpy()


def _state(net) -> dict:
    return {f"{k}/{f}/{n}": t.detach().clone()
            for k, s in net._updater_state.items()
            for f in ("hist", "velocity") for n, t in getattr(s, f).items()
            } | {f"{k}/iteration": s.iteration.clone()
                 for k, s in net._updater_state.items()}


def _states_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------- the fault schedules
def _schedule(name, n_batches):
    x, y = _stream(n_batches)
    if name == "nan_row":
        x[3 * BS + 5, 1] = np.nan
    elif name == "inf_labels":
        y[6 * BS, 0] = np.inf
    elif name == "two_faults_in_a_window":
        x[4 * BS] = np.nan
        y[5 * BS + 1, 2] = -np.inf
    elif name == "persistent_nan":
        x[6 * BS:] = np.nan
    return x, y


SCHEDULES = {  # name -> (batches, policy kwargs, path)
    "nan_row": (10, {"check_every": 2}, "fit"),
    "inf_labels": (10, {"check_every": 3}, "fit"),
    "two_faults_in_a_window": (12, {"check_every": 2, "snapshot_every": 2,
                                    "max_skips_per_window": 2}, "fit"),
    "persistent_nan": (16, {"check_every": 2, "snapshot_every": 4,
                            "max_skips_per_window": 2, "max_rollbacks": 2},
                       "fit"),
    "persistent_nan_fit_scan": (10, {"check_every": 4, "max_rollbacks": 1,
                                     "max_skips_per_window": 3},
                                "fit_scan"),
}


def _drive(net, x, y, policy_kw, path, listener, jax_side):
    policy_cls = jguardian.GuardianPolicy if jax_side else GuardianPolicy
    policy = policy_cls(listeners=[listener], **policy_kw)
    report = None
    try:
        if path == "fit":
            it = (JListIter(JDataSet(x, y), BS) if jax_side
                  else ListDataSetIterator(DataSet(x, y), BS))
            net.fit(it, guardian=policy)
        else:
            net.fit_scan(x, y, BS, epochs=4, guardian=policy)
    except (GuardianAbort, jguardian.GuardianAbort) as e:
        report = e.report
    params = np.asarray(net.params()) if jax_side else _params(net)
    events = [(e.kind, e.step,
               {k: v for k, v in e.info.items()
                if k not in ("score", "last_score", "best_recent_score")})
              for e in listener.events]
    return events, report, params


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_a_fault_schedule_gives_the_jax_packages_events_and_params(name):
    n_batches, policy_kw, path = SCHEDULES[name]
    if path == "fit_scan":
        x, y = _stream(n_batches)
        x[:] = np.nan
    else:
        x, y = _schedule(name, n_batches)
    net, jnet = _pair()
    net.fit(*_stream(1, seed=9))  # an updater state to snapshot
    jnet.fit(*_stream(1, seed=9))
    ours = _drive(net, x, y, policy_kw, path, CollectGuardianEvents(), False)
    theirs = _drive(jnet, x, y, policy_kw, path, JCollect(), True)
    assert ours[0] == theirs[0]
    assert ours[0], "the schedule must reach the ladder"
    if theirs[1] is not None:
        assert ours[1] is not None
        for key in ("steps", "skipped", "rollbacks", "lr_scale", "reason"):
            assert ours[1][key] == theirs[1][key], key
    assert np.isfinite(ours[2]).all()
    np.testing.assert_allclose(ours[2], theirs[2], atol=PARAM_TOL)


# ------------------------------------- the reference's guardian contracts
@pytest.mark.parametrize("stack", sorted(CONFS))
def test_clean_run_matches_unguarded_bit_for_bit(stack):
    x, y = _stream(8)
    a, b = _net(stack), _net(stack)
    a.fit(ListDataSetIterator(DataSet(x, y), BS), epochs=2)
    b.fit(ListDataSetIterator(DataSet(x, y), BS), epochs=2,
          guardian=GuardianPolicy(check_every=3))
    assert torch.equal(a.params(), b.params())
    assert _states_equal(_state(a), _state(b))


@pytest.mark.parametrize("stack", sorted(CONFS))
def test_guarded_fit_scan_matches_unguarded(stack):
    x, y = _stream(5)
    a, b = _net(stack), _net(stack)
    a.fit_scan(x, y, batch_size=BS, epochs=4)
    b.fit_scan(x, y, batch_size=BS, epochs=4,
               guardian=GuardianPolicy(check_every=2))
    assert torch.equal(a.params(), b.params())
    assert _states_equal(_state(a), _state(b))


# ------------------------------------------------------ the guarded step
def test_nan_batch_skips_without_touching_params_or_state():
    x, y = _stream(2)
    net = _net()
    net.fit(x[:BS], y[:BS])
    before, state = net.params().clone(), _state(net)
    xb = x[BS:].copy()
    xb[5] = np.nan
    ev = CollectGuardianEvents()
    net.fit(xb, y[BS:], guardian=GuardianPolicy(check_every=1,
                                                listeners=[ev]))
    assert torch.equal(before, net.params())
    assert _states_equal(state, _state(net))
    assert ev.kinds() == ["skip"]


def test_inf_labels_skip_too():
    x, y = _stream(1)
    net = _net()
    net.fit(x, y)
    before = net.params().clone()
    yb = y.copy()
    yb[0, 0] = np.inf
    net.fit(x, yb, guardian=GuardianPolicy(check_every=1))
    assert torch.equal(before, net.params())


def test_a_skipped_step_leaves_the_updater_iteration_alone():
    x, y = _stream(1)
    net = _net()
    net.fit(x, y)
    it_before = int(net._updater_state["0"].iteration)
    net.fit(np.full_like(x, np.nan), y,
            guardian=GuardianPolicy(check_every=1))
    assert int(net._updater_state["0"].iteration) == it_before


def test_all_finite_is_isfinite_on_every_element_as_in_jax():
    big = np.full((3, 4), 3e38, np.float32)  # finite; its norm is inf
    cases = [(1.0, [big]), (np.nan, [big]), (1.0, [big, np.array(
        [np.inf], np.float32)]), (1.0, [np.array([-np.inf, 0.0],
                                                 np.float32)])]
    for score, leaves in cases:
        ours = guardian.all_finite(torch.tensor(score),
                                   {"a": [torch.from_numpy(v)
                                          for v in leaves]})
        theirs = jguardian.all_finite(jnp.asarray(score),
                                      {"a": [jnp.asarray(v)
                                             for v in leaves]})
        assert ours.dim() == 0 and bool(ours) == bool(theirs)


def test_guarded_update_and_lr_scale_match_jax():
    rng = np.random.default_rng(4)
    p = {"0": {"W": rng.normal(size=(3, 2)).astype(np.float32)}}
    u = {"0": {"W": rng.normal(size=(3, 2)).astype(np.float32)}}
    for poison in (False, True):
        g = {"0": {"W": rng.normal(size=(3, 2)).astype(np.float32)}}
        if poison:
            g["0"]["W"][1, 1] = np.nan
        t = lambda tree: {k: {n: torch.from_numpy(v.copy())  # noqa: E731
                              for n, v in d.items()} for k, d in tree.items()}
        j = lambda tree: {k: {n: jnp.asarray(v)  # noqa: E731
                              for n, v in d.items()} for k, d in tree.items()}
        gs = guardian.guardian_state(0.5, device="cpu")
        jgs = jguardian.GuardianState(jnp.zeros((), jnp.int32),
                                      jnp.asarray(0.5, jnp.float32))
        new_p, new_s, gs2 = guardian.guarded_update(
            t(p), t(p), t(u), t(u), gs, torch.tensor(1.0), t(g))
        jp, js, jgs2 = jguardian.guarded_update(
            j(p), j(p), j(u), j(u), jgs, jnp.asarray(1.0), j(g))
        np.testing.assert_array_equal(new_p["0"]["W"].numpy(),
                                      np.asarray(jp["0"]["W"]))
        np.testing.assert_array_equal(new_s["0"]["W"].numpy(),
                                      np.asarray(js["0"]["W"]))
        assert int(gs2.skipped) == int(jgs2.skipped) == int(poison)
    bf = guardian.apply_lr_scale([torch.ones(2, dtype=torch.bfloat16)],
                                 guardian.guardian_state(0.25, "cpu"))
    assert bf[0].dtype == torch.bfloat16 and float(bf[0][0]) == 0.25


@pytest.mark.parametrize("clean", [True, False])
def test_commit_in_place_equals_the_functional_commit_and_jax(clean):
    """`commit(..., out=live)` (the network's step) writes what the
    functional `commit` (guarded_update) returns, and both what JAX's
    gives; a NaN in the rejected branch never leaks."""
    rng = np.random.default_rng(7)
    old = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    new = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    new[1][2, 0] = np.nan
    ok = torch.tensor(clean)
    live = [torch.from_numpy(v.copy()) for v in old]
    fresh = [torch.from_numpy(v) for v in new]
    functional = guardian.commit(ok, [torch.from_numpy(v) for v in old],
                                 fresh)
    written = guardian.commit(ok, live, fresh, out=live)
    theirs = jguardian.commit(jnp.asarray(clean),
                              [jnp.asarray(v) for v in old],
                              [jnp.asarray(v) for v in new])
    for w, f, t, o in zip(written, functional, theirs, old):
        assert isinstance(functional, list)
        np.testing.assert_array_equal(w.numpy(), f.numpy())
        np.testing.assert_array_equal(w.numpy(), np.asarray(t))
        if not clean:
            np.testing.assert_array_equal(w.numpy(), o)
    assert all(w is v for w, v in zip(written, live))


def test_divergence_rolls_back_via_the_session_as_in_jax():
    def run(session_cls, state_fn, score_fn, live, mutated):
        events = []
        policy = (GuardianPolicy if session_cls is GuardianSession
                  else jguardian.GuardianPolicy)(check_every=1,
                                                 divergence_window=8)
        kw = {"device": "cpu"} if session_cls is GuardianSession else {}
        sess = session_cls(policy, lambda k, s, i: events.append((k, s)),
                           **kw)
        sess.arm(live)
        gst = state_fn()
        for s in (1.0, 0.9, 0.8):
            live, rolled = sess.observe(live, gst, score_fn(s))
            assert not rolled
        out, rolled = sess.observe(mutated, gst, score_fn(50.0))
        return events, rolled, out, float(sess.gstate.lr_scale)

    ours = run(GuardianSession, lambda: guardian.guardian_state(
        device="cpu"), torch.tensor, ({"w": torch.ones(3)},),
        ({"w": torch.full((3,), 7.0)},))
    theirs = run(jguardian.GuardianSession, jguardian.guardian_state,
                 jnp.asarray, ({"w": jnp.ones(3)},),
                 ({"w": jnp.full(3, 7.0)},))
    assert ours[0] == theirs[0] == [("rollback", 4)]
    assert ours[1] and ours[3] == theirs[3] == 0.5
    assert torch.equal(ours[2][0]["w"], torch.ones(3))


def test_abort_leaves_the_network_at_last_good():
    x, y = _stream(12)
    net = _net()
    net.fit(x[:BS], y[:BS])
    good, state = net.params().clone(), _state(net)
    ev = CollectGuardianEvents()
    with pytest.raises(GuardianAbort) as exc:
        net.fit(ListDataSetIterator(DataSet(np.full_like(x, np.nan), y), BS),
                guardian=GuardianPolicy(check_every=2,
                                        max_skips_per_window=2,
                                        max_rollbacks=2, listeners=[ev]))
    assert ev.kinds() == ["rollback", "rollback", "abort"]
    assert exc.value.report["lr_scale"] == pytest.approx(0.25)
    assert torch.equal(good, net.params())
    assert _states_equal(state, _state(net))


@pytest.mark.parametrize("where", ["line_search", "finetune"])
def test_the_guardian_refuses_paths_it_cannot_guard(where):
    if where == "line_search":
        conf = _iris_conf(NeuralNetConfiguration.builder,
                          algo="conjugate_gradient")
        match = "iteration_gradient_descent"
    else:
        conf = _iris_conf(NeuralNetConfiguration.builder)
        conf.backprop = False
        match = "backprop"
    net = MultiLayerNetwork(conf, device="cpu")
    x, y = _stream(1)
    with pytest.raises(ValueError, match=match):
        net.fit(x, y, guardian=GuardianPolicy())


def test_policy_and_guard_validate_their_knobs():
    for kw in ({"max_skips_per_window": 0}, {"max_rollbacks": -1},
               {"check_every": 0}, {"lr_backoff": 0.0},
               {"snapshot_every": 0}):
        with pytest.raises(ValueError):
            GuardianPolicy(**kw)
    x, y = _stream(1)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _net().fit(x, y, checkpoint_every=0, saver=DefaultModelSaver(
            os.devnull))


# ------------------------------------------------ autosave and resume
class _PreemptAt:
    """Preempts the fit after its `at`-th batch (a listener: fit calls
    it once a batch), through the guard or by a real SIGTERM."""

    def __init__(self, at, how="request"):
        self.at, self.how, self.count = at, how, 0

    def iteration_done(self, model, iteration, score):
        self.count += 1
        if self.count == self.at:
            if self.how == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                model.guard.request_preemption()


def test_preemption_flushes_a_committed_checkpoint(tmp_path):
    x, y = _stream(8)
    net = _net()
    net.set_listeners([_PreemptAt(3)])
    root = str(tmp_path / "ck")
    with ShardedModelSaver(root) as saver, \
            pytest.raises(TrainingPreempted) as exc:
        net.fit(ListDataSetIterator(DataSet(x, y), BS), saver=saver)
    assert exc.value.position == 3
    assert exc.value.path.endswith("step_0000000003")
    assert latest_step(root) == 3  # committed before the raise
    got, info = restore_network(root, device="cpu")
    assert torch.equal(got.params(), net.params())
    assert info["metadata"]["save_kind"] == "preempt"


def test_a_real_sigterm_is_handled_and_the_old_handler_restored(tmp_path):
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        x, y = _stream(8)
        net = _net()
        net.set_listeners([_PreemptAt(2, how="sigterm")])
        path = str(tmp_path / "p.ckpt")
        with pytest.raises(TrainingPreempted) as exc:
            net.fit(ListDataSetIterator(DataSet(x, y), BS),
                    saver=DefaultModelSaver(path, keep_old=False))
        assert exc.value.path == path and exc.value.position == 2
        assert seen == []  # the guard's handler took it
        _, info = load_checkpoint(path, device="cpu")
        assert info["iterator_position"] == 2
        os.kill(os.getpid(), signal.SIGTERM)  # the old handler is back
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, previous)


def _resume_run(tmp_path, x, y, epochs, stops, **fit_kw):
    """Train with preemptions after the listed batch counts (each resumed
    from the latest checkpoint by restore_network), then to the end."""
    root = str(tmp_path / "resume")
    net = _net()
    start = {}
    feed_skip = 0
    remaining = epochs
    for stop in stops + [None]:
        feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), BS),
                          device="cpu")
        feed.fast_forward(feed_skip)
        net.set_listeners([_PreemptAt(stop)] if stop else [])
        with ShardedModelSaver(root, keep=2) as saver:
            try:
                net.fit(feed, epochs=remaining, saver=saver, **fit_kw,
                        **start)
            except TrainingPreempted:
                pass
            else:
                return net
        net, info = restore_network(root, device="cpu")
        meta = info["metadata"]
        start = {"start_position": info["iterator_position"],
                 "start_epoch": meta["epoch"],
                 "start_epoch_batch": meta["epoch_batch"]}
        feed_skip = meta["epoch_batch"]
        remaining = epochs - meta["epoch"]
    raise AssertionError("unreachable")


@pytest.mark.parametrize("guarded", [False, True])
def test_a_twice_preempted_resume_equals_the_uninterrupted_run(tmp_path,
                                                               guarded):
    """Two preemptions inside the second epoch (after 2 and 3 more
    batches): the second resume must fast-forward past everything
    trained, so the run ends bit-equal to the uninterrupted one."""
    x, y = _stream(6)
    kw = ({"guardian": GuardianPolicy(check_every=4, snapshot_every=8),
           "checkpoint_every": 4} if guarded else {})
    ref = _net()
    with ShardedModelSaver(str(tmp_path / "ref")) as saver:
        ref.fit(DeviceFeed(ListDataSetIterator(DataSet(x, y), BS),
                           device="cpu"), epochs=2, saver=saver, **kw)
    got = _resume_run(tmp_path, x, y, 2, [8, 3], **kw)
    assert torch.equal(got.params(), ref.params())
    assert _states_equal(_state(got), _state(ref))
    assert got._iteration_count == ref._iteration_count == 12


def test_fit_scan_resumes_by_epochs(tmp_path):
    x, y = _stream(4)
    ref = _net()
    ref.fit_scan(x, y, BS, epochs=5)
    root = str(tmp_path / "scan")
    net = _net()
    net.set_listeners([])
    with ShardedModelSaver(root) as saver:
        net.fit_scan(x, y, BS, epochs=3, checkpoint_every=1, saver=saver,
                     guardian=GuardianPolicy(check_every=4))
    net2, info = restore_network(root, device="cpu")
    assert info["iterator_position"] == 3
    with ShardedModelSaver(root) as saver:
        net2.fit_scan(x, y, BS, epochs=2, checkpoint_every=1, saver=saver,
                      guardian=GuardianPolicy(check_every=4),
                      start_position=info["iterator_position"])
    assert latest_step(root) == 5
    assert torch.equal(net2.params(), ref.params())


@pytest.mark.parametrize("case", ["fit_every_4", "fit_multi_epoch",
                                  "fit_scan_per_epoch"])
def test_autosave_cursors_match_jax(tmp_path, case):
    x, y = _stream(10 if case == "fit_every_4" else 5)
    net, jnet = _pair()
    ours, theirs = str(tmp_path / "ours.ckpt"), str(tmp_path / "jax.ckpt")
    if case == "fit_every_4":
        net.fit(ListDataSetIterator(DataSet(x, y), BS),
                guardian=GuardianPolicy(), checkpoint_every=4,
                saver=DefaultModelSaver(ours, keep_old=False))
        jnet.fit(JListIter(JDataSet(x, y), BS),
                 guardian=jguardian.GuardianPolicy(), checkpoint_every=4,
                 saver=JDefault(theirs, keep_old=False))
    elif case == "fit_multi_epoch":
        net.fit(ListDataSetIterator(DataSet(x, y), BS), epochs=3,
                checkpoint_every=7,
                saver=DefaultModelSaver(ours, keep_old=False))
        jnet.fit(JListIter(JDataSet(x, y), BS), epochs=3,
                 checkpoint_every=7, saver=JDefault(theirs, keep_old=False))
    else:
        net.fit_scan(x, y, BS, epochs=4, checkpoint_every=2,
                     saver=DefaultModelSaver(ours, keep_old=False))
        jnet.fit_scan(x, y, batch_size=BS, epochs=4, checkpoint_every=2,
                      saver=JDefault(theirs, keep_old=False))
    _, info = load_checkpoint(ours, device="cpu")
    _, jinfo = jload(theirs)
    assert info["iterator_position"] == jinfo["iterator_position"]
    for key in ("epoch", "epoch_batch", "save_kind"):
        assert info["metadata"][key] == jinfo["metadata"][key]
    if "guardian" in jinfo["metadata"]:
        for key in ("steps", "skipped", "rollbacks", "lr_scale"):
            assert info["metadata"]["guardian"][key] == \
                jinfo["metadata"]["guardian"][key]


# ---------------------------------------------- the feed and the data
@pytest.mark.parametrize("skip", [0, 3, 9])
def test_fast_forward_and_cursor_match_jax(skip):
    x, y = _stream(7)
    x, y = x[:-5], y[:-5]  # a ragged last batch
    ours = DeviceFeed(ListDataSetIterator(DataSet(x, y), BS), device="cpu")
    theirs = jfeed.DeviceFeed(JListIter(JDataSet(x, y), BS))
    trace, jtrace = [], []
    for feed, out, jax_side in ((ours, trace, False),
                                (theirs, jtrace, True)):
        feed.fast_forward(skip)
        for _ in range(2):  # the skip is one-shot
            for fb in feed:
                f = np.asarray(fb.features) if jax_side else \
                    fb.features.numpy()
                out.append((feed.cursor, int(fb.n_valid), f[0, 0]))
    assert trace == jtrace
    with pytest.raises(ValueError):
        ours.fast_forward(-1)


def test_the_feed_has_the_iterator_surface():
    class Closing(ListDataSetIterator):
        closed = False

        def close(self):
            self.closed = True

    src = Closing(DataSet(*_stream(2)), BS)
    feed = DeviceFeed(src, device="cpu")
    assert feed.batch() == BS
    next(iter(feed))
    feed.reset()
    assert src.cursor == 0
    feed.close()
    assert src.closed


def test_iris_matches_jax():
    ours, theirs = load_iris(), jload_iris()
    np.testing.assert_array_equal(ours.features, np.asarray(theirs.features))
    np.testing.assert_array_equal(ours.labels, np.asarray(theirs.labels))
    it, jit = IrisDataSetIterator(40, num_examples=100), JIris(40, 100)
    got = [(d.features, d.labels) for d in it]
    ref = [(d.features, d.labels) for d in jit]
    assert len(got) == len(ref) == 3
    for (f, l), (jf, jl) in zip(got, ref):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(l, jl)
    assert it.input_columns() == 4 and it.total_outcomes() == 3


def test_the_nan_injected_iris_run_recovers_close_to_clean():
    """bench.py's recovery drill at CPU size: one poisoned batch in a
    stream of 150; the guarded run's score within 1e-3 of the clean
    run's, and the port's params within 2e-5 of the JAX package's."""
    x, y = _stream(150)
    data = load_iris()
    clean, _ = _pair()
    clean.fit(ListDataSetIterator(DataSet(x, y), BS))
    xb = x.copy()
    xb[7 * BS:8 * BS] = np.nan
    net, jnet = _pair()
    policy = dict(check_every=4, snapshot_every=16)
    net.fit(ListDataSetIterator(DataSet(xb, y), BS),
            guardian=GuardianPolicy(**policy))
    jnet.fit(JListIter(JDataSet(xb, y), BS),
             guardian=jguardian.GuardianPolicy(**policy))
    assert np.isfinite(_params(net)).all()
    assert abs(net.score(data.features, data.labels)
               - clean.score(data.features, data.labels)) < 1e-3
    np.testing.assert_allclose(_params(net), np.asarray(jnet.params()),
                               atol=PARAM_TOL)


# ----------------------------------------------------------------- card
@pytest.mark.cuda
def test_a_guarded_fit_scan_on_the_card_has_no_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    conf = _iris_conf(NeuralNetConfiguration.builder)
    net = MultiLayerNetwork(conf, device="cuda")
    ref = MultiLayerNetwork(conf, device="cuda")
    x, y = (torch.from_numpy(a).cuda() for a in _stream(4))
    policy = GuardianPolicy(check_every=10 ** 9, snapshot_every=10 ** 9)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        net.fit_scan(x, y, BS, epochs=2, guardian=policy, sync=False)
        ref.fit_scan(x, y, BS, epochs=2, sync=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(net.params(), ref.params())
