from .decorator import (batch, buffered, cache, chain, compose, firstn,  # noqa: F401
                        map_readers, multiprocess_reader, shuffle, xmap_readers)
