"""I/O: tabular data recorders, scene serialization, config system.

JAX-native replacement for the reference's cross-cutting I/O layers
(ref: core/recorders/data_record.hpp:159,334 + ssv/tsv/bin/vector/tcp/udp
back-ends; core/serialization/* archives; Boost.program_options bundles).
"""
from reak_tpu.io.recorder import (
    Recorder,
    MemoryRecorder,
    CsvRecorder,
    BinaryRecorder,
    TcpRecorder,
    UdpRecorder,
    NetworkServer,
    open_recorder,
    open_extractor,
)
from reak_tpu.io.serialization import (
    register_type,
    save_scene,
    load_scene,
    to_document,
    from_document,
)
from reak_tpu.io.config import Config, config_from_args, config_from_file
from reak_tpu.io import native_recorder
from reak_tpu.io import profiling

__all__ = [
    "Recorder",
    "MemoryRecorder",
    "CsvRecorder",
    "BinaryRecorder",
    "TcpRecorder",
    "UdpRecorder",
    "NetworkServer",
    "open_recorder",
    "open_extractor",
    "register_type",
    "save_scene",
    "load_scene",
    "to_document",
    "from_document",
    "Config",
    "config_from_args",
    "config_from_file",
]
