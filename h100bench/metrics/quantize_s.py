"""Seconds of the port's quantize calls and engine layouts in set-up (host
clock around them, ended by a device synchronize)."""

NAME = "quantize_s"
UNIT = "s"
LAYER = "quantizer"
MOVES = "setup_s"


def read(obs):
    return obs.get("quantize_s")
