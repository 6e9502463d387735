"""The port's numpy modules (data, topology, faults, schedule, configs)
against the JAX package's: the same seeds give byte-identical batch stacks,
partitions and W stacks, so both packages train on the same stream."""
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core import schedule as ref_schedule
from repro.core import topology as ref_topology
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.data import dirichlet as ref_dirichlet
from repro.data import synthetic as ref_synthetic
from repro.launch.train import build_cpu_preset as ref_cpu_preset
from repro.launch.train import sample_segment_batches as ref_segment_batches
from repro_torch.configs import get_config
from repro_torch.core import schedule, topology
from repro_torch.core.faults import FaultPlan
from repro_torch.data import dirichlet, synthetic
from repro_torch.launch.train import build_cpu_preset, sample_segment_batches


def _lm_pair(vocab=64, seed=3):
    return (ref_synthetic.SyntheticLM(vocab=vocab, num_domains=8, seed=seed),
            synthetic.SyntheticLM(vocab=vocab, num_domains=8, seed=seed))


def test_synthetic_lm_tables_and_mixtures_identical():
    ref, port = _lm_pair()
    assert ref._trans.tobytes() == port._trans.tobytes()
    a = ref.domain_mixtures(6, 0.1, seed=4)
    b = port.domain_mixtures(6, 0.1, seed=4)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rounds,local_steps", [(1, 1), (3, 2)])
def test_segment_batches_byte_identical(rounds, local_steps):
    ref, port = _lm_pair()
    mix = ref.domain_mixtures(4, 0.1, seed=1)
    a = ref_segment_batches(ref, mix, rounds, local_steps, 4, 16,
                            np.random.default_rng(2))
    b = sample_segment_batches(port, mix, rounds, local_steps, 4, 16,
                               np.random.default_rng(2))
    assert sorted(a) == sorted(b)
    for k in a:
        x = np.asarray(a[k])
        assert x.shape == (rounds, local_steps, 4, 4, 16)
        assert x.dtype == b[k].dtype and x.tobytes() == b[k].tobytes()


def test_dirichlet_partition_identical():
    labels = np.random.default_rng(0).integers(0, 10, size=500)
    a = ref_dirichlet.dirichlet_partition(labels, 5, 0.1,
                                          np.random.default_rng(7), 8)
    b = dirichlet.dirichlet_partition(labels, 5, 0.1,
                                      np.random.default_rng(7), 8)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name", ["identity", "fully_connected", "ring",
                                  "exponential"])
def test_static_topologies_identical(name):
    for m in (2, 5, 8):
        assert (getattr(ref_topology, name)(m).tobytes()
                == getattr(topology, name)(m).tobytes())


@pytest.mark.parametrize("sched,kw", [
    ("final_merge", {}), ("constant", {}), ("local", {}),
    ("windowed", {"start": 2, "end": 5}), ("periodic", {"period": 3})])
def test_schedule_w_stream_identical(sched, kw):
    m, rounds = 8, 12
    a = ref_schedule.make_schedule(sched, m, rounds, prob=0.2, seed=5, **kw)
    b = schedule.make_schedule(sched, m, rounds, prob=0.2, seed=5, **kw)
    Wa = np.stack([a.mixing_matrix(t) for t in range(rounds)])
    Wb = np.stack([b.mixing_matrix(t) for t in range(rounds)])
    assert Wa.tobytes() == Wb.tobytes()
    assert [a.round_cost(W) for W in Wa] == [b.round_cost(W) for W in Wb]
    assert a.last_kind == b.last_kind


def test_fault_plan_degraded_stream_identical():
    spec = "2@3-6;0@8"
    a = ref_schedule.make_schedule("final_merge", 4, 10, seed=1,
                                   faults=RefFaultPlan.parse(4, spec))
    b = schedule.make_schedule("final_merge", 4, 10, seed=1,
                               faults=FaultPlan.parse(4, spec))
    for t in range(10):
        assert a.mixing_matrix(t).tobytes() == b.mixing_matrix(t).tobytes()
        assert a.last_live.tobytes() == b.last_live.tobytes()


def test_configs_identical():
    for ref_cfg, cfg in [(ref_get_config("olmo-1b"), get_config("olmo-1b")),
                         (ref_cpu_preset(ref_get_config("olmo-1b"), 4),
                          build_cpu_preset(get_config("olmo-1b"), 4))]:
        assert cfg.padded_vocab == ref_cfg.padded_vocab
        assert repr(cfg) == repr(ref_cfg)
    assert get_config("olmo-1b").padded_vocab == 50432


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_classification_byte_identical(seed):
    """The figure harness's data: the blobs, the Dirichlet partitions and a
    stream of per-agent batches from one default_rng, byte for byte."""
    kw = dict(num_classes=10, dim=32, n_train=4096, n_test=1024, seed=seed)
    ref = ref_synthetic.SyntheticClassification(**kw)
    port = synthetic.SyntheticClassification(**kw)
    for name in ("centers", "x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    pa, pb = ref.partition(8, 0.1, seed=seed + 1), port.partition(
        8, 0.1, seed=seed + 1)
    assert len(pa) == len(pb) == 8
    for x, y in zip(pa, pb):
        assert x.tobytes() == y.tobytes()
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        xa, ya = ref_synthetic.make_agent_batches(ref, pa, 32, ra)
        xb, yb = synthetic.make_agent_batches(port, pb, 32, rb)
        assert xa.shape == (8, 32, 32) and xa.tobytes() == xb.tobytes()
        assert ya.dtype == yb.dtype and ya.tobytes() == yb.tobytes()


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_topology_diagnostics_identical(m):
    """partner_array, is_doubly_stochastic, spectral_p and expected_p: the
    same floats, exactly."""
    rng = np.random.default_rng(m)
    mats = [ref_topology.random_matching(m, 0.7, rng) for _ in range(3)]
    mats += [ref_topology.ring(m), ref_topology.exponential(m),
             ref_topology.fully_connected(m), ref_topology.identity(m),
             np.full((m, m), 0.5)]
    for W in mats:
        assert (ref_topology.partner_array(W).tobytes()
                == topology.partner_array(W).tobytes())
        assert (ref_topology.is_doubly_stochastic(W)
                == topology.is_doubly_stochastic(W))
        assert ref_topology.spectral_p(W) == topology.spectral_p(W)
    for kind in ("random", "ring", "exponential", "full", "none"):
        a = ref_topology.expected_p(ref_topology.make_sampler(kind, m, 0.2),
                                    m, 50, np.random.default_rng(1))
        b = topology.expected_p(topology.make_sampler(kind, m, 0.2), m, 50,
                                np.random.default_rng(1))
        assert a == b, kind
