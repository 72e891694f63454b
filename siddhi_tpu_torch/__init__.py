"""siddhi_tpu_torch — the PyTorch/CUDA port of siddhi_tpu.

SiddhiQL over unbounded event streams, executed as columnar
micro-batches on one NVIDIA GPU: the host layer (parser, type checker,
planner, junctions, packed ingest encoder) is the reference's, and each
query step runs as hand-written CUDA kernels (csrc/) with plain PyTorch
versions beside them for the CPU. The JAX package ``siddhi_tpu`` is the
reference this package is held against; this package imports neither
it nor JAX.
"""
from .core.manager import SiddhiManager
from .core.persistence import (FileSystemPersistenceStore,
                               InMemoryPersistenceStore, PersistenceStore)
from .core.stream import Event, QueryCallback, StreamCallback
from .core.types import AttrType
from .lang.parser import parse, parse_expression, parse_query
from .resilience.errorstore import (ErroredEvent, ErrorStore,
                                    FileSystemErrorStore, InMemoryErrorStore)
from .resilience.supervisor import (CheckpointSupervisor,
                                    PoolCheckpointSupervisor)
from .serving import AdmissionError, Template, TemplateRegistry, TenantPool

__all__ = [
    "AdmissionError",
    "AttrType",
    "CheckpointSupervisor",
    "ErrorStore",
    "ErroredEvent",
    "Event",
    "FileSystemErrorStore",
    "FileSystemPersistenceStore",
    "InMemoryErrorStore",
    "InMemoryPersistenceStore",
    "PersistenceStore",
    "PoolCheckpointSupervisor",
    "QueryCallback",
    "SiddhiManager",
    "StreamCallback",
    "Template",
    "TemplateRegistry",
    "TenantPool",
    "parse",
    "parse_expression",
    "parse_query",
]
