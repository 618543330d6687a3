"""Constants the port's text2music and LM planner paths need (own copy; same
values as the JAX package's constants module)."""

SAMPLE_RATE = 48000
LATENT_HOP = 1920                 # samples per latent frame -> 25 Hz
LATENT_RATE = SAMPLE_RATE / LATENT_HOP

MIN_DURATION_S = 10.0
MAX_DURATION_S = 600.0

FRAME_BUCKET = 256                # latent frames per sequence bucket (~10.24 s)
TOKEN_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

# LM planner (5 Hz audio codes)
LM_CODE_RATE = 5                  # LM audio codes per second
AUDIO_CODEBOOK_SIZE = 64000       # <|audio_code_N|>, N in [0, 64000)

# The LM planners were fine-tuned on these exact prompts: they are checkpoint
# data and must match byte for byte.
DEFAULT_LM_INSTRUCTION = "Generate audio semantic tokens based on the given conditions:"
DEFAULT_LM_UNDERSTAND_INSTRUCTION = (
    "Understand the given musical conditions and describe the audio semantics accordingly:"
)
DEFAULT_LM_INSPIRED_INSTRUCTION = (
    "Expand the user's input into a more detailed and specific musical description:"
)
DEFAULT_LM_REWRITE_INSTRUCTION = (
    "Format the user's input into a more detailed and specific musical description:"
)
DEFAULT_NEGATIVE_PROMPT = "NO USER INPUT"
