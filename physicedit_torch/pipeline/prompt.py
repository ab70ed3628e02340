"""Prompt templating, special tokens, and reasoner output parsing: the
port's own copy of ``physicedit_tpu/pipeline/prompt.py``.

Reproduces the reference's prompt conventions:
- T2I template with drop_idx 34 (qwen_image_physical.py:763-764),
- edit template with vision placeholder and drop_idx 64 (:775-784),
- multi-image "Picture i:" convention (:802-813),
- the 64 latent-transition special tokens appended as a suffix (:778-783),
- the physical-reasoning system prompts (:80-155) and the strict-JSON
  response contract (:875-907).
"""

from __future__ import annotations

import json

SPECIAL_TOKEN_NUM = 64

T2I_TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, "
    "size, texture, quantity, text, spatial relationships of the objects and "
    "background:<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n"
    "<|im_start|>assistant\n"
)
T2I_DROP_IDX = 34

EDIT_TEMPLATE = (
    "<|im_start|>system\nDescribe the key features of the input image (color, "
    "shape, size, texture, objects, background), then explain how the user's "
    "text instruction should alter or modify the image. Generate a new image "
    "that meets the user's requirements while maintaining consistency with "
    "the original input where appropriate.<|im_end|>\n<|im_start|>user\n"
    "<|vision_start|><|image_pad|><|vision_end|>{}<|im_end|>\n"
    "<|im_start|>assistant\n"
)
EDIT_DROP_IDX = 64

PICTURE_TEMPLATE = "Picture {}: <|vision_start|><|image_pad|><|vision_end|>"

SPECIAL_TOKENS = (["<begin_of_img>"]
                  + [f"<img{i}>" for i in range(SPECIAL_TOKEN_NUM)]
                  + ["<end_of_img>"])

SPECIAL_SUFFIX = ("\n<begin_of_img>"
                  + "".join(f"<img{i}>" for i in range(SPECIAL_TOKEN_NUM))
                  + "<end_of_img><|im_end|>")


def edit_prompt_text(prompt: str) -> str:
    """The full tokenizer input for the edit path, special tokens appended."""
    return EDIT_TEMPLATE.format(prompt + SPECIAL_SUFFIX)


def multi_edit_prompt_text(prompt: str, num_images: int) -> str:
    imgs = "".join(PICTURE_TEMPLATE.format(i + 1) for i in range(num_images))
    template = EDIT_TEMPLATE.replace(
        "<|vision_start|><|image_pad|><|vision_end|>", "")
    return template.format(imgs + prompt)


# --- Physical reasoning prompts (summarised contract, not verbatim prose) --

# System prompt for the inference-time reasoner (reference
# SYSTEM_PROMPT_SAMPLE, qwen_image_physical.py:136-155): the model receives
# an edit instruction + edit image and must return strict JSON with a
# physically-plausible step-by-step transition description.
REASONER_SYSTEM_PROMPT = (
    "You are a physics-aware visual editing assistant.\n"
    "You will receive an \"Edit Instruction\" and an \"Edit Image\".\n"
    "Your task is to generate a detailed description of the edit operations "
    "required to transform the image according to the instruction, ensuring "
    "all changes strictly follow physical laws.\n\n"
    "INPUTS:\n- Edit Instruction: The desired modification.\n"
    "- Edit Image: The visual starting point.\n\n"
    "REQUIREMENTS:\n"
    "1. Physical Plausibility: All operations must respect physics (like "
    "gravity, inertia, material properties, light transport, collision, "
    "etc.).\n"
    "2. Mechanism of Change: Describe *how* the change occurs visually "
    "(e.g., \"The vase tilts and falls due to gravity,\" not just \"The "
    "vase is on the floor\").\n"
    "3. Material Consistency: Ensure materials behave correctly (liquids "
    "flow, solids rigid/deform, cloth wrinkles).\n\n"
    "OUTPUT FORMAT:\nReturn STRICT JSON ONLY:\n"
    "{\n  \"middle_transition_prompt\": \"A multi-clause paragraph "
    "describing the step-by-step physical operations and visual "
    "transition.\"\n}"
)

ACCEPTED_FIELD_SETS = (
    ("Reasoning",),
    ("physical_reasoning", "middle_transition_prompt", "final_state_prompt"),
    ("middle_transition_prompt",),
)


def parse_reasoner_response(response: str) -> dict:
    """Strict-JSON parse of the reasoner output (qwen_image_physical.py:875-907).

    Raises ValueError on malformed output; the caller falls back to the raw
    text (matching generate_text's behaviour at :866-869).
    """
    start = response.find("{")
    end = response.rfind("}")
    if start == -1 or end == -1 or end <= start:
        raise ValueError(f"no JSON object in response: {response[:200]}")
    data = json.loads(response[start:end + 1])

    # DETERMINISTIC field order (declaration order, dict-deduped).  The
    # reference iterates a set comprehension here (qwen_image_physical.py:892)
    # whose str order is hash-salted per process — the appended conditioning
    # text (and so the image) would differ between runs/hosts; on a
    # multihost SPMD mesh that would make processes embed different prompts
    # and diverge.  Documented divergence: we pin declaration order.
    allowed = list(dict.fromkeys(
        f for fields in ACCEPTED_FIELD_SETS for f in fields))
    result = {}
    for key in allowed:
        value = data.get(key)
        if value is not None:
            if not isinstance(value, str):
                raise ValueError(f"field {key} must be a string")
            result[key] = value.strip()
    if not any(set(result) == set(fields) for fields in ACCEPTED_FIELD_SETS):
        raise ValueError(f"unsupported response keys: {sorted(result)}")
    return result


def reasoner_text_from_response(response: str) -> str:
    """Map a generation to the physical_txt appended to the prompt."""
    try:
        parsed = parse_reasoner_response(response)
    except ValueError:
        return response
    return "".join(f"\n{k}: {v}" for k, v in parsed.items())


def reasoner_chat_text(system_prompt: str, user_items: list) -> str:
    """Build the chat string for the reasoner (Qwen2-VL chat format with
    add_vision_id=True: images are numbered "Picture N: ...").

    user_items: list of ("text", str) or ("image",) tuples in order.
    """
    parts = []
    img_n = 0
    for item in user_items:
        if item[0] == "text":
            parts.append(item[1])
        else:
            img_n += 1
            parts.append(PICTURE_TEMPLATE.format(img_n))
    user = "".join(parts)
    return (f"<|im_start|>system\n{system_prompt}<|im_end|>\n"
            f"<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n")
