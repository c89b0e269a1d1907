"""Online draft distillation: the serving fleet teaches its own
speculative draft from live traffic.

Port of ``torchkafka_tpu/distill``'s serving half: the distill-topic wire
(``wire.py``, a copy) and the refresh controller with its in-process
loop (``controller.py``). The server publishes committed completions
(``StreamingGenerator(distill_topic=...)``) and
``ServingFleet.start_distill`` closes the loop through
``swap_draft_params``. The trainer (``DistillTrainer``) and its worker
process (``run_distill_worker``) are not ported yet (ROADMAP queue A:
process fleet and disaggregated prefill).
"""

from torchkafka_tpu_torch.distill.controller import (
    DistillController,
    DistillPolicy,
    InProcessDistillDriver,
)
from torchkafka_tpu_torch.distill.wire import (
    decode_completion,
    distill_processor,
    encode_completion,
)

__all__ = [
    "DistillController",
    "DistillPolicy",
    "InProcessDistillDriver",
    "decode_completion",
    "distill_processor",
    "encode_completion",
]
