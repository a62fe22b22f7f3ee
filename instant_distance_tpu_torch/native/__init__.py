"""The host engine: multithreaded builds and host queries (C++)."""

from .cpu import NativeHnsw, available, load_error  # noqa: F401
