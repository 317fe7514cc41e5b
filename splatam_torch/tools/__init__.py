"""Command-line tools: run statistics, NeRFCapture capture and the iPhone
demo (counterparts of ``splatam_tpu/tools/``)."""
