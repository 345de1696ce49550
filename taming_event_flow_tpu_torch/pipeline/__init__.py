"""The eval loop logic behind the eval entry point."""

from .eval import (  # noqa: F401
    EvalPipeline,
    MetricsConsumer,
    VisPolicy,
    consume_mets,
    initialize_quant_results,
)
