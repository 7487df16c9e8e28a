"""The port's calibrated simulator (core/simulator.py) against the JAX
package's: the same `SimConfig` and seed give identical `SimResult` rows
for every method, and the same request streams."""
import dataclasses

import pytest

from repro.core import simulator as jsim
from repro_torch.core import simulator as sim

CONFIGS = {
    "saturated-70b": dict(cloud_model="llama3-70b", cloud_batch=20, rpm=30,
                          n_requests=120),
    "small-cloud": dict(cloud_model="llama3-8b", cloud_batch=80,
                        edge_models=("qwen2.5-7b", "qwen2.5-1.5b"), rpm=120,
                        n_requests=120),
    "static": dict(cloud_model="llama3-70b", cloud_batch=20, rpm=60,
                   n_requests=100, dynamic=False, seed=3),
    "narrow-link": dict(rpm=45, n_requests=80, bandwidth_mbps=5.0,
                        n_edge_devices=2, queue_max=2, seed=7),
}


@pytest.mark.parametrize("method", sorted(sim.METHODS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rows_equal_jax_package(method, name):
    kw = CONFIGS[name]
    ours = sim.METHODS[method](sim.SimConfig(**kw))
    ref = jsim.METHODS[method](jsim.SimConfig(**kw))
    assert ours.row() == ref.row()
    assert ours.completed > 0


@pytest.mark.parametrize("n,rpm,seed", [(50, 30.0, 0), (200, 120.0, 5)])
def test_make_requests_equal_jax_package(n, rpm, seed):
    ours = [dataclasses.astuple(r) for r in sim.make_requests(n, rpm, seed)]
    ref = [dataclasses.astuple(r) for r in jsim.make_requests(n, rpm, seed)]
    assert ours == ref


def test_routing_threshold_equal_jax_package():
    cfg = dict(rpm=60, n_requests=100, seed=2)
    for thr in (0.2, 0.45, 0.8):
        ours = sim.simulate_routing(sim.SimConfig(**cfg), easy_threshold=thr)
        ref = jsim.simulate_routing(jsim.SimConfig(**cfg), easy_threshold=thr)
        assert ours.row() == ref.row()
