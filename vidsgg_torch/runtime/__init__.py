"""Runtime helpers of the port (counterpart of ``vidsgg/runtime``)."""
