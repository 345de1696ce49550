"""The eval loop logic behind the eval entry point."""

from .eval import (  # noqa: F401
    EvalPipeline,
    MetricsConsumer,
    VisPolicy,
    batch_stream,
    consume_mets,
    initialize_quant_results,
)
