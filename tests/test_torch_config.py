"""The PyTorch port's configuration (deeplearning4j_tpu_torch/config/)
held against the JAX package: the builder, `ListBuilder.override`,
`hidden_layer_sizes`, the preprocessor registry, and the JSON wire
format, which must load in either package whichever wrote it.
"""

from __future__ import annotations

import json

import pytest

import __graft_entry__
from deeplearning4j_tpu.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import preprocessors as jax_pp
from deeplearning4j_tpu_torch.config import (MultiLayerConfiguration,
                                             NeuralNetConfiguration)
from deeplearning4j_tpu_torch.config.multi_layer_configuration import (
    PREPROCESSOR_REGISTRY)
from deeplearning4j_tpu_torch.nn import preprocessors as pp


def _build(conf_cls, pp_mod):
    """One stacked conf through either package's builder: per-layer
    overrides by kwargs and by callback, a momentum schedule, nested
    preprocessors."""
    def widen(i, c):
        c.l2 = 1e-3 * (i + 1)

    return (conf_cls.builder()
            .lr(0.03).n_in(20).activation_function("tanh")
            .momentum(0.5).momentum_after({3: 0.9}).use_regularization(True)
            .compute_dtype("bfloat16").seed(7)
            .list(3)
            .hidden_layer_sizes([16, 8])
            .override(-1, fn=widen)
            .override(0, dropout=0.1, weight_init="size")
            .override(2, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=5)
            .input_preprocessor(0, pp_mod.AggregatePreProcessor(
                [pp_mod.ReshapePreProcessor([20]),
                 pp_mod.BinomialSamplingPreProcessor()]))
            .input_preprocessor(2, pp_mod.ConvolutionPostProcessor())
            .pretrain(False)
            .build())


def test_builder_gives_the_jax_packages_configuration():
    port = _build(NeuralNetConfiguration, pp)
    ref = _build(JConf, jax_pp)
    assert port.to_dict() == ref.to_dict()
    assert [c.l2 for c in port.confs] == [1e-3, 2e-3, 3e-3]
    assert port.confs[0].dropout == 0.1 and port.confs[1].dropout == 0.0


def test_json_written_by_jax_loads_in_the_port_and_back():
    s = _build(JConf, jax_pp).to_json()
    port = MultiLayerConfiguration.from_json(s)
    assert port.to_json() == s
    assert isinstance(port.input_preprocessors[0], pp.AggregatePreProcessor)
    assert isinstance(port.input_preprocessors[0].preprocessors[1],
                      pp.BinomialSamplingPreProcessor)
    assert port.confs[1].momentum_after == {3: 0.9}


def test_json_written_by_the_port_loads_in_jax_and_back():
    s = _build(NeuralNetConfiguration, pp).to_json()
    ref = JMLC.from_json(s)
    assert ref.to_json() == s
    assert isinstance(ref.input_preprocessors[2],
                      jax_pp.ConvolutionPostProcessor)


def test_single_layer_conf_round_trips_both_ways():
    port = NeuralNetConfiguration.builder().lr(0.2).n_in(3).n_out(4) \
        .filter_size([5, 5]).stride([2, 2]).dist(
            {"type": "uniform", "lower": -1, "upper": 1}).build()
    ref = JConf.from_json(port.to_json())
    assert ref.to_json() == port.to_json()
    assert NeuralNetConfiguration.from_json(ref.to_json()) == port


def test_entry_lenet_conf_builds_in_both_packages():
    """__graft_entry__.entry()'s LeNet-5, built by the JAX package, loads
    in the port with the same layers and preprocessors."""
    forward, (params, _) = __graft_entry__.entry()
    net = dict(zip(forward.__code__.co_freevars,
                   (c.cell_contents for c in forward.__closure__)))["net"]
    port = MultiLayerConfiguration.from_json(net.conf.to_json())
    assert [c.layer for c in port.confs] == ["conv", "conv", "dense",
                                             "output"]
    assert isinstance(port.input_preprocessors[0],
                      pp.ConvolutionInputPreProcessor)
    assert port.to_json() == net.conf.to_json()
    assert sorted(params) == ["0", "1", "2", "3"]


def test_momentum_schedule_matches_jax():
    port = NeuralNetConfiguration(momentum=0.5,
                                  momentum_after={2: 0.7, 5: 0.9})
    ref = JConf(momentum=0.5, momentum_after={2: 0.7, 5: 0.9})
    assert [port.momentum_for_iteration(i) for i in range(8)] == \
        [ref.momentum_for_iteration(i) for i in range(8)]


def test_copy_deep_copies_mutable_fields():
    a = NeuralNetConfiguration(filter_size=[5, 5], momentum_after={1: 0.9})
    b = a.copy(lr=0.5)
    b.filter_size[0] = 3
    b.momentum_after[2] = 0.1
    assert a.filter_size == [5, 5] and a.momentum_after == {1: 0.9}
    assert b.lr == 0.5
    with pytest.raises(AttributeError):
        a.copy(nope=1)


def test_bad_fields_and_names_raise():
    with pytest.raises(AttributeError, match="No config field"):
        NeuralNetConfiguration.builder().learning_rate(0.1)
    d = NeuralNetConfiguration().to_dict()
    d["nope"] = 1
    with pytest.raises(ValueError, match="Unknown NeuralNetConfiguration"):
        NeuralNetConfiguration.from_dict(d)
    bad = json.loads(_build(NeuralNetConfiguration, pp).to_json())
    bad["input_preprocessors"]["0"]["name"] = "nope"
    with pytest.raises(ValueError, match="Unknown preprocessor"):
        MultiLayerConfiguration.from_dict(bad)


def test_preprocessor_registry_names_are_the_jax_packages():
    from deeplearning4j_tpu.config.multi_layer_configuration import (
        PREPROCESSOR_REGISTRY as JAX_REGISTRY)
    assert sorted(PREPROCESSOR_REGISTRY) == sorted(JAX_REGISTRY)
