"""Dataset readers with the JAX package's sample schemas.  Only the
synthetic generators are ported: each reader yields the same arrays from
the same seed as the JAX package's synthetic branch, and nothing is
downloaded or read from a cache."""
from . import cifar, imdb, mnist, sentiment, uci_housing  # noqa: F401
from .common import DATA_HOME  # noqa: F401
