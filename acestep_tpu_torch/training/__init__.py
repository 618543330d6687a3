"""Training-side helpers of the port (only the dataset builder's
``audio_to_codes`` so far)."""
