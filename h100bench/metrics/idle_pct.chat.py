"""Share of the traced window with no kernel running: one minus the union of
the kernel intervals of ``torch.profiler``'s device timeline over the window."""

NAME = "idle_pct.chat"
UNIT = "%"
LAYER = "device"
MOVES = "gen_tok_s"


def read(obs):
    reading = obs.get("trace")
    if reading is None or not reading.kernels:
        return None
    return 100.0 * (1.0 - reading.busy_s() / reading.window_s)
