from automl_tpu_torch.search.program import (  # noqa: F401
    Program, FunctionRegistry, default_registry, program_to_optimizer,
)
from automl_tpu_torch.search import evolution  # noqa: F401
