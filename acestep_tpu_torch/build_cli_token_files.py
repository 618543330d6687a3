"""Style and lyric token files for the port's CLI, formatted exactly as the
pipeline's text-encoder inputs: the style text is the caption and metadata
through ``SFT_GEN_PROMPT``, the lyrics tokenize raw.  Port of the JAX
package's tools/build_cli_token_files.py; both write the same bytes.

    python -m acestep_tpu_torch.build_cli_token_files --tokenizer CKPT/tokenizer.json \\
        --caption "dreamy synthwave" --metas "bpm: 105" --lyrics-file lyrics.txt \\
        --out-dir token_files/
    python -m acestep_tpu_torch.cli --pipeline-style-lyric \\
        --style-tokens token_files/style_tokens.txt \\
        --lyric-tokens token_files/lyric_tokens.txt

Reads the tokenizer with the ``tokenizers`` package; needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys

from acestep_tpu_torch.constants import (DEFAULT_DIT_INSTRUCTION, MAX_LYRIC_TOKENS,
                                         MAX_STYLE_TOKENS, SFT_GEN_PROMPT)


def build_style_text(caption: str, metas: str, instruction: str = DEFAULT_DIT_INSTRUCTION) -> str:
    """The exact prompt the DiT text encoder sees."""
    return SFT_GEN_PROMPT.format(instruction, caption, metas)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tokenizer", required=True, help="path to tokenizer.json")
    ap.add_argument("--caption", default="")
    ap.add_argument("--metas", default="")
    ap.add_argument("--instruction", default=DEFAULT_DIT_INSTRUCTION)
    ap.add_argument("--lyrics", default="")
    ap.add_argument("--lyrics-file", default=None)
    ap.add_argument("--out-dir", default="token_files")
    args = ap.parse_args(argv)

    from tokenizers import Tokenizer

    tok = Tokenizer.from_file(args.tokenizer)
    os.makedirs(args.out_dir, exist_ok=True)

    style_text = build_style_text(args.caption, args.metas, args.instruction)
    style_ids = tok.encode(style_text, add_special_tokens=False).ids[:MAX_STYLE_TOKENS]
    with open(os.path.join(args.out_dir, "style_tokens.txt"), "w") as f:
        f.write(" ".join(str(i) for i in style_ids))

    lyrics = args.lyrics
    if args.lyrics_file:
        with open(args.lyrics_file) as f:
            lyrics = f.read()
    if lyrics:
        lyric_ids = tok.encode(lyrics, add_special_tokens=False).ids[:MAX_LYRIC_TOKENS]
        with open(os.path.join(args.out_dir, "lyric_tokens.txt"), "w") as f:
            f.write(" ".join(str(i) for i in lyric_ids))

    print(f"style: {len(style_ids)} tokens"
          + (f"; lyrics: {len(lyric_ids)} tokens" if lyrics else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
