from .ft import FaultTolerantLoop, StragglerWatchdog  # noqa: F401
