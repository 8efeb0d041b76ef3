"""Flash decode's share of its roofline over the int8 cache: the least time of the work the cell's inputs need
(``benchlib/roofline.py``) over the device time of the kernels that ``PATTERN``
names in the traced window."""

NAME = "flash_decode_roofline.chat"
UNIT = "%"
LAYER = "kernels"
MOVES = "gen_tok_s"

PATTERN = r"\bflash_decode_kernel\b"


def read(obs):
    reading, least = obs.get("trace"), obs.get("least_s", {}).get("flash_decode")
    if reading is None or not least:
        return None
    spent = reading.device_s(PATTERN)
    return 100.0 * least / spent if spent else None
