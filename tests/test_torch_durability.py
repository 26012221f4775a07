"""The durability hooks of the port's streaming index against the JAX
package: the ``compaction.rebuild`` fault point at the top of
`stream.compaction.rebuild_base`, the ``stream.*`` counters of
`obs.metrics`, `Compactor.status()` and the ``promips-stream`` adapter's
`maintenance_status()`; and the engine's ``serve.decode`` fault point.

The same writes, compactions and injected faults on a JAX stream and on the
port's (each package has its own fault injector and metrics registry) give
the same counter values and the same compaction status. The registries are
process-wide: each test restores their enabled flag and disarms every
fault point at teardown.
"""
import numpy as np
import pytest

from repro import api as jax_api
from repro.obs import metrics as jax_metrics
from repro.robust.faultpoints import fault as jax_fault
from repro.stream import MutableProMIPS as JaxMutableProMIPS
from repro.stream.compaction import CompactionConfig as JaxCompactionConfig
from repro.stream.compaction import Compactor as JaxCompactor
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.data.synthetic import mf_factors
from repro_torch.models import transformer as T
from repro_torch.obs import metrics
from repro_torch.robust import FaultInjected, fault
from repro_torch.serve import DecodeEngine
from repro_torch.stream import (CompactionConfig, Compactor, MutableProMIPS,
                                rebuild_base)

BUILD = dict(m=6, c=0.9, p=0.6, k_p=5, k_sp=8, seed=0)
STREAM_COUNTERS = ("stream.delta_appends", "stream.deletes",
                   "stream.compactions", "stream.compaction_errors",
                   "stream.compaction_retries")


@pytest.fixture
def registries():
    """Both metrics registries enabled and empty; restored afterwards."""
    prev = (jax_metrics.enabled(), metrics.enabled())
    for reg in (jax_metrics, metrics):
        reg.reset()
        reg.enable()
    yield
    for reg, was in zip((jax_metrics, metrics), prev):
        reg.reset()
        (reg.enable if was else reg.disable)()
    jax_fault.disarm()
    fault.disarm()


@pytest.fixture(scope="module")
def corpus():
    x = mf_factors(900, 24, 6, decay=0.5, norm_tail=0.6, seed=0)
    new = mf_factors(120, 24, 6, decay=0.5, norm_tail=0.6, seed=3)
    return x, new


def _ops(stream, new, inject, compactor_cls, config_cls):
    """Writes, a synchronous compaction, then a background rebuild that
    fails once and succeeds on its retry."""
    stream.insert(np.arange(900, 960), new[:60])
    stream.delete(np.arange(0, 40, 2))
    stream.update([1, 3, 905], new[60:63])
    stream.compact()
    stream.insert(np.arange(960, 1000), new[63:103])
    stream.delete([5, 970])
    stream.compactor = compactor_cls(config_cls(max_retries=1, backoff_s=0.001))
    inject.arm("compaction.rebuild", times=1)
    stream.compactor.start(stream)
    stream.join_compaction(timeout=120)
    return stream.compactor.status()


def test_stream_counters_and_status_match_jax(corpus, registries):
    x, new = corpus
    jst = JaxMutableProMIPS(x, **BUILD)
    tst = MutableProMIPS(x, device="cpu", **BUILD)
    jstatus = _ops(jst, new, jax_fault, JaxCompactor, JaxCompactionConfig)
    tstatus = _ops(tst, new, fault, Compactor, CompactionConfig)
    jsnap, tsnap = jax_metrics.snapshot(), metrics.snapshot()
    for name in STREAM_COUNTERS:
        assert tsnap.get(name) == jsnap.get(name), name
    assert tsnap["stream.compaction_errors"] == 1
    assert tsnap["stream.compaction_retries"] == 1
    assert tsnap["stream.compactions"] == 2
    assert tsnap["robust.faults_injected"] == jsnap["robust.faults_injected"] == 1
    assert tstatus == jstatus
    assert tstatus["runs"] == 1 and tstatus["retries"] == 1
    assert not tstatus["error_latched"]
    np.testing.assert_array_equal(np.sort(tst.alive_items()[0]),
                                  np.sort(jst.alive_items()[0]))


def test_armed_fault_raises_in_the_rebuild(corpus, registries):
    x, new = corpus
    fault.arm("compaction.rebuild", times=1)
    with pytest.raises(FaultInjected, match="compaction.rebuild"):
        rebuild_base(np.arange(len(x)), x, BUILD)
    st = MutableProMIPS(x, device="cpu", **BUILD)      # disarmed again
    st.insert([2000], new[:1])
    fault.arm("compaction.rebuild", times=1)
    with pytest.raises(FaultInjected):
        st.compact()
    assert st.churn_fraction > 0 and 2000 in st.alive_items()[0]   # intact
    st.compactor = Compactor()                          # no retries: latched
    jst = JaxMutableProMIPS(x, **BUILD)
    jst.insert([2000], new[:1])
    jst.compactor = JaxCompactor()
    for stream, inject in ((st, fault), (jst, jax_fault)):
        inject.arm("compaction.rebuild", times=1)
        stream.compactor.start(stream)
        stream.compactor._thread.join(120)
    assert st.compactor.status() == jst.compactor.status()
    assert st.compactor.status()["error_latched"]
    with pytest.raises(RuntimeError, match="background compaction failed"):
        st.join_compaction()
    assert not st.compactor.status()["error_latched"]


def test_maintenance_status_matches_jax(corpus):
    x, _ = corpus
    kw = dict(guarantee=api.GuaranteeConfig(c=0.9, p0=0.6), seed=0, m=6,
              auto_compact=True)
    ours = api.build(x, backend="promips-stream", device="cpu", **kw)
    jkw = dict(kw, guarantee=jax_api.GuaranteeConfig(c=0.9, p0=0.6))
    ref = jax_api.build(x, backend="promips-stream", **jkw)
    assert ours.maintenance_status() == ref.maintenance_status()
    assert ours.maintenance_status()["compaction"]["runs"] == 0


def test_serve_decode_fault_point(registries):
    cfg = get_config("tinyllama-1.1b").reduced()
    eng = DecodeEngine(T.init_params(cfg, device="cpu"), cfg, device="cpu",
                       batch_slots=2, max_len=16)
    eng.submit(np.arange(1, 5), max_new_tokens=3)
    fault.arm("serve.decode", after=1, times=1)
    eng.step()
    with pytest.raises(FaultInjected, match="serve.decode"):
        eng.step()
    eng.run()
    assert eng.steps == 3 and metrics.snapshot()["robust.faults_injected"] == 1
