"""Standalone tool modes mirroring the reference's native binaries
(TERefiner_1 modes and auxiliary evaluation scripts); counterpart of
gappadder_tpu/tools/."""
