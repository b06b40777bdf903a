"""Count-to-text prompt formatting for CLIP-EBC.

The port's own copy of ``clip_ebc_tpu/models/clip/prompts.py``: integer
counts up to 100 (plus round hundreds and 1000) are spelled out as
English words; anything else falls back to the numeral string.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

_ONES = (
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
)
_TENS = (
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
)


def num2word(num: Union[int, float, str]) -> str:
    """Spell an integer in [0, 99], round hundreds, or 1000 as English words."""
    n = int(num)
    if 0 <= n < 20:
        return _ONES[n]
    if 20 <= n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] if ones == 0 else f"{_TENS[tens]}-{_ONES[ones]}"
    if n in (100, 200, 300, 400, 500, 600, 700, 800, 900):
        return f"{_ONES[n // 100]} hundred"
    if n == 1000:
        return "one thousand"
    return str(n)


def format_count(
    count: Union[int, float, Tuple[float, float]], prompt_type: str = "word"
) -> str:
    """Render a bin (scalar for degenerate bins, (low, high) otherwise) as a prompt."""
    if prompt_type not in ("word", "number"):
        raise ValueError(f"prompt_type must be 'word' or 'number', got {prompt_type}")
    word = prompt_type == "word"
    if isinstance(count, (int, float)):
        if count == 0:
            return "There is no person." if word else "There is 0 person."
        if count == 1:
            return "There is one person." if word else "There is 1 person."
        n = int(count)
        return f"There are {num2word(n)} people." if word else f"There are {n} people."
    low, high = count
    if math.isinf(high):
        n = int(low)
        return (
            f"There are more than {num2word(n)} people."
            if word
            else f"There are more than {n} people."
        )
    lo, hi = int(low), int(high)
    if word:
        return f"There are between {num2word(lo)} and {num2word(hi)} people."
    return f"There are between {lo} and {hi} people."


def bin_prompts(
    bins: Sequence[Tuple[float, float]], prompt_type: str = "word"
) -> Tuple[str, ...]:
    """Prompts for a bin list; degenerate bins (lo == hi) render as scalars."""
    return tuple(
        format_count(lo if lo == hi else (lo, hi), prompt_type) for lo, hi in bins
    )
