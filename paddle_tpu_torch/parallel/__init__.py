"""Multi-device training on DTensor: meshes (``mesh``), declarative
layouts (``layout``), ``ParallelExecutor``, ring attention and the GPipe
pipeline (the JAX package's ``parallel/``; ROADMAP §A item 12b)."""
from .parallel_executor import (BuildStrategy, ExecutionStrategy, ParallelExecutor,
                                ReduceStrategy)
from .mesh import CANONICAL_AXES, Mesh, layout_mesh, make_mesh
from .layout import Sharding, SpecLayout, as_placements, shard_program_state
from .pipeline import pipeline_apply
