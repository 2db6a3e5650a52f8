from raw_image_pipeline_tpu.utils.logging import get_logger
from raw_image_pipeline_tpu.utils.profiling import trace_profile

__all__ = ["get_logger", "trace_profile"]
