"""PyTorch/CUDA port of torchkafka_tpu: streaming training with
commit-after-step offsets and continuous-batching serving, on an NVIDIA
H100.

The package mirrors ``torchkafka_tpu``'s module paths so each piece has an
obvious counterpart, and exports the ported part of its public surface
under the same names. It imports ``torch`` and numpy, never ``jax`` and
never the JAX package. Entry points run on CUDA unless the caller passes
``device="cpu"`` (``utils.devices.resolve_device``). The kernels are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
into ``_build/`` (``ops/_native.py``); nothing is built at import.

    stream = KafkaStream(consumer, fixed_width(512, np.int32), batch_size=8)
    init_fn, step_fn = make_train_step(cfg, optimizer=adamw(1e-3))
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    for batch, token in stream:
        params, opt, loss = step_fn(params, opt, batch.data, None)
        token.commit(wait_for=loss)     # barrier, then commit THIS batch
"""

from torchkafka_tpu_torch.checkpoint import StreamCheckpointer
from torchkafka_tpu_torch.commit import (
    CommitBarrier,
    CommitToken,
    LocalBarrier,
    OffsetLedger,
)
from torchkafka_tpu_torch.errors import (
    BarrierError,
    BrokerUnavailableError,
    CommitFailedError,
    ConsumerClosedError,
    FencedMemberError,
    JournalLockedError,
    OutputDeliveryError,
    PoisonRecordError,
    ProducerClosedError,
    ProducerFencedError,
    QuorumLostError,
    StaleEpochError,
    TpuKafkaError,
    TransactionStateError,
)
from torchkafka_tpu_torch.journal import DecodeJournal, JournalEntry
from torchkafka_tpu_torch.kvcache import HostTier, TierConfig
from torchkafka_tpu_torch.models.transformer import make_train_step
from torchkafka_tpu_torch.obs import (
    BurnRateMonitor,
    MetricsExporter,
    ObsConfig,
    RecordTrace,
    RecordTracer,
    SLOTarget,
)
from torchkafka_tpu_torch.optim import adam, adamw
from torchkafka_tpu_torch.parallel import batch_sharding, global_batch, make_mesh
from torchkafka_tpu_torch.pipeline import KafkaStream, stream
from torchkafka_tpu_torch.resilience import (
    CircuitBreaker,
    ManualClock,
    PoisonQuarantine,
    ResilientConsumer,
    RetryPolicy,
)
from torchkafka_tpu_torch.source.assignment import partitions_for_process
from torchkafka_tpu_torch.source import (
    BrokerCell,
    BrokerClient,
    BrokerServer,
    ChaosConsumer,
    ChaosProducer,
    ChaosTransport,
    FollowerReplica,
    KafkaConsumer,
    KafkaProducer,
    KafkaTransactionalProducer,
    ReplicationConfig,
    Replicator,
    WireFaults,
)
from torchkafka_tpu_torch.source.consumer import Consumer, seek_to_timestamp
from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
from torchkafka_tpu_torch.source.producer import (
    MemoryProducer,
    Producer,
    RecordMetadata,
    TransactionalProducer,
    dead_letter_to_topic,
)
from torchkafka_tpu_torch.source.records import Record, TopicPartition
from torchkafka_tpu_torch.source.wal import WriteAheadLog
from torchkafka_tpu_torch.transform import (
    Batch,
    Batcher,
    chunk_of,
    chunked,
    compose,
    encode_png_rgb,
    fixed_width,
    json_field,
    json_tokens,
    png_images,
    raw_bytes,
)
from torchkafka_tpu_torch.utils.shutdown import ShutdownSignal

__all__ = [
    "BarrierError",
    "Batch",
    "Batcher",
    "BrokerCell",
    "BrokerClient",
    "BrokerServer",
    "BrokerUnavailableError",
    "BurnRateMonitor",
    "ChaosConsumer",
    "ChaosProducer",
    "ChaosTransport",
    "CircuitBreaker",
    "CommitBarrier",
    "CommitFailedError",
    "CommitToken",
    "Consumer",
    "ConsumerClosedError",
    "DecodeJournal",
    "FencedMemberError",
    "FollowerReplica",
    "HostTier",
    "InMemoryBroker",
    "JournalEntry",
    "JournalLockedError",
    "KafkaConsumer",
    "KafkaProducer",
    "KafkaStream",
    "KafkaTransactionalProducer",
    "LocalBarrier",
    "ManualClock",
    "MemoryConsumer",
    "MemoryProducer",
    "MetricsExporter",
    "ObsConfig",
    "OffsetLedger",
    "OutputDeliveryError",
    "PoisonQuarantine",
    "PoisonRecordError",
    "Producer",
    "ProducerClosedError",
    "ProducerFencedError",
    "QuorumLostError",
    "Record",
    "RecordMetadata",
    "RecordTrace",
    "RecordTracer",
    "ReplicationConfig",
    "Replicator",
    "ResilientConsumer",
    "RetryPolicy",
    "SLOTarget",
    "ShutdownSignal",
    "StaleEpochError",
    "StreamCheckpointer",
    "TierConfig",
    "TopicPartition",
    "TpuKafkaError",
    "TransactionStateError",
    "TransactionalProducer",
    "WireFaults",
    "WriteAheadLog",
    "adam",
    "adamw",
    "batch_sharding",
    "chunk_of",
    "chunked",
    "compose",
    "encode_png_rgb",
    "dead_letter_to_topic",
    "fixed_width",
    "global_batch",
    "json_field",
    "json_tokens",
    "png_images",
    "make_mesh",
    "make_train_step",
    "partitions_for_process",
    "raw_bytes",
    "seek_to_timestamp",
    "stream",
]
