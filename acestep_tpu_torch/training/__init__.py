"""Training-side helpers of the port: the dataset builder's
``audio_to_codes`` and the LoRA merge (``lora``); training itself is still to
be ported."""
