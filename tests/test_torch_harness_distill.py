"""The port's scenario 25 (online draft distillation over a speculative
fleet, ``torchkafka_tpu_torch.harness``) on the CPU at tiny size:
``tests/test_harness.py``'s case for it re-rooted onto the port with
``device="cpu"`` (the same assertions: α degrades at the hot-set drift
and recovers after a post-drift refresh, the trainer trains and
publishes, committed tokens byte-identical to a never-distilled fleet,
nothing duplicated or lost). The JAX scenario is not run here; its own
case runs in ``tests/test_harness.py``.

Also the pump it drives: ``DistillTrainer.run`` polls its corpus topic no
longer than its idle timeout, so the fleet's per-round ``run(max_steps=2,
idle_timeout_ms=1)`` returns at once on an idle topic."""

import numpy as np
import torch

import torchkafka_tpu_torch as ptk
from _torch_fleet_common import load_rerooted
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu_torch.harness import run_scenario


def _cpu_run(num, size="tiny", **kw):
    return run_scenario(num, size, device="cpu", **kw)


_h = load_rerooted("test_harness")
_h.run_scenario = _cpu_run
test_scenario_25_online_draft_distillation = _h.test_scenario_25_online_draft_distillation


class _PollSpy:
    """A consumer that records the timeout of every poll."""

    def __init__(self, inner):
        self.inner, self.timeouts = inner, []

    def poll(self, *a, timeout_ms=None, **k):
        self.timeouts.append(timeout_ms)
        return self.inner.poll(*a, timeout_ms=timeout_ms, **k)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_trainer_poll_waits_no_longer_than_its_idle_timeout():
    from torchkafka_tpu_torch.distill import DistillTrainer
    from torchkafka_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=64, max_seq_len=24, dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    broker = ptk.InMemoryBroker()
    broker.create_topic("d", partitions=1)
    spy = _PollSpy(ptk.MemoryConsumer(broker, "d", group_id="tr"))
    trainer = DistillTrainer(spy, params, cfg, seq_len=24, batch_size=8, draft_layers=1)
    report = trainer.run(max_steps=2, idle_timeout_ms=1)
    assert report["steps"] == 0
    assert spy.timeouts and max(spy.timeouts) <= 1
    spy.timeouts.clear()
    trainer.run(max_steps=2, idle_timeout_ms=500)
    assert np.all(np.asarray(spy.timeouts) == 100)  # the stream's default wait
    spy.inner.close()
