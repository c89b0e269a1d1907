"""Online draft distillation — the serving fleet teaches its own
speculative draft from live traffic. Port of ``torchkafka_tpu/distill``.

The closed loop, each leg an existing subsystem pointed at the next:

    serve (exactly-once txn window)
      └─ distill topic (wire.py — committed completions, CRC-framed)
           └─ DistillTrainer (trainer.py — KafkaStream + make_train_step
              over the layer-truncated draft)
                └─ checkpoint topic (source/checkpoint_wire.py —
                   versioned, torn-publish-rejecting)
                     └─ DistillController (controller.py — windowed
                        live-α gate, hysteresis, typed trace decisions)
                          └─ swap_draft_params (serve_spec.py — between
                             ticks, no quiesce) ─ back to serve

Committed tokens are invariant around the whole cycle: the corpus only
ever holds committed tokens (publisher rides the commit window), and a
draft refresh only changes the PROPOSER (the target's verification
commits) — both ends differential-tested and SIGKILL-matrixed.
"""

from torchkafka_tpu_torch.distill.controller import (
    DistillController,
    DistillPolicy,
    InProcessDistillDriver,
)
from torchkafka_tpu_torch.distill.trainer import DistillTrainer
from torchkafka_tpu_torch.distill.wire import (
    decode_completion,
    distill_processor,
    encode_completion,
)
from torchkafka_tpu_torch.distill.worker import run_distill_worker

__all__ = [
    "DistillController",
    "DistillPolicy",
    "DistillTrainer",
    "InProcessDistillDriver",
    "decode_completion",
    "distill_processor",
    "encode_completion",
    "run_distill_worker",
]
