"""ngx — a batched JAX NovelGridworlds engine.

A from-scratch JAX/XLA re-design of the capabilities of
``gtatiya/gym-novel-gridworlds``: every environment is a declarative
:class:`~ngx.core.spec.EnvSpec`, the step is one fused branchless kernel
(:mod:`ngx.core.step`) that batches under ``jit(vmap(...))`` and shards over a
device mesh (:mod:`ngx.parallel`), observation/action wrappers are pure
transforms (:mod:`ngx.transforms`), and the 13 novelty injections are spec
rewrites (:mod:`ngx.novelty`).
"""

__version__ = "0.1.0"

from .core.spec import EnvSpec  # noqa: F401
from .core.state import EnvState, StepInfo  # noqa: F401
from .core.step import make_step  # noqa: F401
from .core.reset import make_reset  # noqa: F401
from .presets import SPEC_BUILDERS, make_spec  # noqa: F401
from .novelty import inject_novelty  # noqa: F401
from . import transforms  # noqa: F401
