"""Constants the port's engine, codec and LM planner paths need (own copy; same
values as the JAX package's constants module)."""

SAMPLE_RATE = 48000
LATENT_HOP = 1920                 # samples per latent frame -> 25 Hz
LATENT_RATE = SAMPLE_RATE / LATENT_HOP
LATENT_DIM = 64
TIMBRE_FIX_FRAMES = 750           # 30 s reference-audio window of the timbre encoder

MIN_DURATION_S = 10.0
MAX_DURATION_S = 600.0

FRAME_BUCKET = 256                # latent frames per sequence bucket (~10.24 s)
TOKEN_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

TASK_TYPES = ("text2music", "repaint", "cover", "extract", "lego", "complete")
TURBO_TASKS = ("text2music", "repaint", "cover")

# LM planner (5 Hz audio codes)
LM_CODE_RATE = 5                  # LM audio codes per second
AUDIO_CODEBOOK_SIZE = 64000       # <|audio_code_N|>, N in [0, 64000)
CODES_PER_LATENT = 5              # 5 Hz codes -> 25 Hz latents

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

# The DiT text encoder's style prompt (the caption and metadata through this
# template) and the token limits of the style and lyric inputs
# (build_cli_token_files); checkpoint data too.
DEFAULT_DIT_INSTRUCTION = "Fill the audio semantic mask based on the given conditions:"
SFT_GEN_PROMPT = """# Instruction
{}

# Caption
{}

# Metas
{}<|endoftext|>
"""
MAX_STYLE_TOKENS = 256
MAX_LYRIC_TOKENS = 2048
