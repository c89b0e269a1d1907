"""torch-kafka compatibility surface.

The reference package exports exactly two names
(the reference's src/__init__.py:17-18); so does this module. A torch-kafka
user migrates with one import change:

    from torchkafka_tpu_torch.compat import KafkaDataset, auto_commit

(or ``import torchkafka`` via the shim package, keeping their imports
byte-identical). Requires torch; the TPU-native core does not.
"""

from torchkafka_tpu_torch.compat.auto_commit import auto_commit
from torchkafka_tpu_torch.compat.dataset import KafkaDataset

__all__ = ["KafkaDataset", "auto_commit"]
