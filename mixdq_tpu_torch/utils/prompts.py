"""Prompt sources for calibration/evaluation, a copy of
``mixdq_tpu/utils/prompts.py`` (plain Python: the port imports nothing of
the JAX package).

The reference samples COCO-2014 validation captions
(``prepare_coco_text_and_image``, qdiff/utils.py:594-613). This
environment has no dataset download, so we support (a) a COCO-format
captions JSON, (b) a plain text file (one prompt per line), (c) a
built-in caption list in the COCO style for offline runs.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

BUILTIN_PROMPTS: List[str] = [
    "a man with a red helmet on a small moped on a dirt road",
    "a woman wearing a net on her head cutting a cake",
    "a child holding a flowered umbrella and petting a yak",
    "a young man holding an umbrella next to a herd of cattle",
    "a narrow kitchen filled with appliances and cooking utensils",
    "a giraffe eating food from the top of a tree",
    "a zebra grazing on lush green grass in a field",
    "a large passenger airplane flying through the air",
    "a bathroom with a toilet, sink, and shower",
    "two men playing frisbee in a green park",
    "a cat sitting on a window sill looking outside",
    "a plate of food with rice, broccoli and meat",
    "a double decker bus driving down a city street",
    "a group of people standing on a snowy ski slope",
    "a brown horse standing in a grassy field",
    "a laptop computer sitting on top of a wooden desk",
    "a stop sign at an intersection on a city street",
    "a bowl of fruit including apples, bananas and oranges",
    "a baseball player swinging a bat at a ball",
    "a small boat floating on a calm lake at sunset",
    "a train traveling down tracks next to a forest",
    "a pizza topped with cheese, pepperoni, and basil",
    "a teddy bear sitting on a bed with a blanket",
    "a surfer riding a large wave in the ocean",
    "an elephant walking through tall grass in the savanna",
    "a clock tower rising above old city buildings",
    "a vase of colorful flowers on a kitchen table",
    "a man riding a skateboard down a handrail",
    "two dogs playing with a ball in the backyard",
    "a motorcycle parked on the side of the road",
    "a kite flying high in a clear blue sky",
    "a bird perched on a branch of a blossoming tree",
]


def load_prompts(path: Optional[str] = None, n: Optional[int] = None) -> List[str]:
    """Load prompts from a COCO captions json / plain text file, or fall
    back to the built-in list (cycled to length ``n``)."""
    if path and os.path.exists(path):
        if path.endswith(".json"):
            with open(path) as f:
                data = json.load(f)
            # COCO captions format: {'annotations': [{'caption': ...}, ...]}
            anns = data.get("annotations", data)
            prompts = [a["caption"] if isinstance(a, dict) else str(a)
                       for a in anns]
        else:
            with open(path) as f:
                prompts = [line.strip() for line in f if line.strip()]
    else:
        prompts = list(BUILTIN_PROMPTS)
    if n is not None:
        while len(prompts) < n:
            prompts = prompts + prompts
        prompts = prompts[:n]
    return prompts
