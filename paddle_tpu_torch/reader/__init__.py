from .decorator import (batch, buffered, cache, chain, compose, firstn,  # noqa: F401
                        map_readers, multiprocess_reader, shuffle, xmap_readers)
from .device_loader import DeviceLoader  # noqa: F401
