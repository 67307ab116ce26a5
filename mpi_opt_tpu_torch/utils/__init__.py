"""Host-side helpers of the port: sweep metrics, FLOP accounting, exit
codes, resource classification, snapshot integrity and checkpoints."""
