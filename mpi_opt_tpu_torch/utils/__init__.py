"""Host-side helpers of the port: sweep metrics and FLOP accounting."""
