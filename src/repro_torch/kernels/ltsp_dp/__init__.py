"""The LTSP DP wavefront: CUDA kernel (:mod:`.ltsp_dp`, :mod:`.build`), plain
torch version (:mod:`.ref`) and host drivers (:mod:`.ops`)."""
