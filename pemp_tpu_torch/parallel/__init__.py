"""Data parallel over episodes (``mesh``: the process world, its shards
and collectives) and the host-to-device input path (``step``: the wire
format and the device prefetcher); the counterpart of
``pemp_tpu/parallel/``."""
