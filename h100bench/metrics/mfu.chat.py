"""Model FLOPs of the traced window (``benchlib/roofline.py``: 2 x active
parameters a token plus attention's products) over the window times the
card's dense bf16 peak (989 TFLOP/s)."""

NAME = "mfu.chat"
UNIT = "%"
LAYER = "device"
MOVES = "gen_tok_s"

from h100bench.benchlib.roofline import H100


def read(obs):
    reading, flops = obs.get("trace"), obs.get("model_flops")
    if reading is None or not flops:
        return None
    return 100.0 * flops / (reading.window_s * H100.peak_ops_per_s("bf16"))
