"""FSM-constrained metadata decoding for the CoT phase (the port's own copy of
the JAX package's constrained.py: host numpy, line for line, so the compiled
tables are the same bits).

During phase 1 the LM must emit the metadata block in the canonical field
order with value-constrained tokens:

    bpm: <int>            (numeric range)
    timesignature: <int>
    keyscale: <key> major|minor   (keyscale trie)
    duration: <int>
    language: <code>      (language trie)
    caption: <free text until newline>
    genres: <genre vocab> (genres trie)
    </think>

User-provided metadata is injected verbatim: the FSM force-feeds the exact
token sequence for fixed fields.  The codes phase (audio-code range mask +
duration-constrained EOS) lives in serving.lm.SamplingParams.

The FSM is tokenizer-agnostic: it consumes decoded token STRINGS and exposes
``allowed`` over a vocab list.  ``MetadataFSM`` is stepped on the host
(serving.lm.generate_with_fsm); ``compile_dfa`` turns the same machine into
tables that the device decode loop reads (serving.lm.generate_with_fsm_device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

FIELD_ORDER = ("bpm", "timesignature", "keyscale", "duration", "language",
               "caption", "genres")

KEYS = ["C", "C#", "Db", "D", "D#", "Eb", "E", "F", "F#", "Gb", "G", "G#",
        "Ab", "A", "A#", "Bb", "B"]
KEYSCALES = [f"{k} {m}" for k in KEYS for m in ("major", "minor")]

LANGUAGES = ["en", "zh", "ja", "ko", "es", "fr", "de", "it", "pt", "ru",
             "ar", "hi", "tr", "vi", "th", "id", "nl", "pl", "sv", "he"]

DEFAULT_GENRES = [
    "pop", "rock", "jazz", "classical", "electronic", "hip hop", "r&b",
    "country", "folk", "metal", "blues", "reggae", "soul", "funk", "ambient",
    "house", "techno", "trance", "punk", "indie", "synthwave", "neo-soul",
    "lo-fi", "orchestral", "acoustic", "latin", "afrobeat", "k-pop", "city pop",
]

FIELD_RANGES = {"bpm": (30, 300), "timesignature": (1, 12), "duration": (10, 600)}


class TokenTrie:
    """Prefix trie over strings; tells which next CHARACTERS keep a valid prefix."""

    def __init__(self, values: Sequence[str]):
        self.values = set(values)
        self.sig = hash(tuple(sorted(self.values)))   # content key for mask tables
        self.prefixes: Set[str] = set()
        for v in values:
            for i in range(len(v) + 1):
                self.prefixes.add(v[:i])

    def valid_continuations(self, prefix: str, piece: str) -> bool:
        return (prefix + piece) in self.prefixes

    def is_complete(self, text: str) -> bool:
        return text in self.values


def load_genres_vocab(path: Optional[str] = None) -> list:
    """Load the genres vocabulary from a file (one genre per line, ``#``
    comments; re-read when the file's mtime changes).  Falls back to
    DEFAULT_GENRES when the file is absent.

    ``path`` defaults to genres_vocab.txt next to this module (the JAX package
    also reads ACESTEP_TPU_GENRES_FILE; here the path is the argument)."""
    import os

    path = path or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "genres_vocab.txt")
    try:
        mtime = os.path.getmtime(path)
        cached = _GENRES_CACHE.get(path)
        if cached and cached[0] == mtime:
            return cached[1]
        with open(path, encoding="utf-8") as f:
            vocab = [ln.strip() for ln in f
                     if ln.strip() and not ln.lstrip().startswith("#")]
        if vocab:
            _GENRES_CACHE[path] = (mtime, vocab)
            return vocab
    except OSError:
        pass
    return list(DEFAULT_GENRES)


_GENRES_CACHE: dict = {}


@dataclasses.dataclass
class FSMConfig:
    genres_vocab: Sequence[str] = dataclasses.field(
        default_factory=load_genres_vocab)
    max_caption_chars: int = 300
    fields: Sequence[str] = FIELD_ORDER


class PieceIndex:
    """Static per-vocab index for O(log V) forced-text masks.

    The reference precomputes per-state token-mask tables
    (constrained_logits_processor.py:548-648); the equivalent here: pieces
    sorted once, so a forced-text state's allowed set — pieces that are a
    prefix of the forced text, plus pieces the forced text is a prefix of —
    resolves with dict hits + one bisect range instead of an O(V) string scan
    (151k-piece vocabs pay ~100 ms per scan)."""

    def __init__(self, token_strs: Sequence[str]):
        self.n = len(token_strs)
        self.by_piece: Dict[str, List[int]] = {}
        for i, p in enumerate(token_strs):
            self.by_piece.setdefault(p, []).append(i)
        self.sorted_pieces = sorted(self.by_piece)
        # empty pieces (special/byte-fallback ids that decode to "") never
        # advance the FSM — allowing them stalls generation until the token
        # budget runs out, so they are masked out of every state
        self.nonempty = np.array([bool(p) for p in token_strs])

    def forced_mask(self, forced: str) -> np.ndarray:
        import bisect

        mask = np.zeros(self.n, bool)
        # pieces that are a (non-empty) prefix of the forced text
        for l in range(1, len(forced) + 1):
            for i in self.by_piece.get(forced[:l], ()):
                mask[i] = True
        # pieces the full forced text is a proper prefix of
        lo = bisect.bisect_left(self.sorted_pieces, forced)
        for j in range(lo, len(self.sorted_pieces)):
            p = self.sorted_pieces[j]
            if not p.startswith(forced):
                break
            for i in self.by_piece[p]:
                mask[i] = True
        return mask


# global (vocab id -> PieceIndex) and (vocab id + state sig -> mask) tables:
# masks per FSM state are STATIC sets, so they persist across FSM instances /
# requests instead of being recomputed per generation
_PIECE_INDEX: dict = {}
_MASK_TABLE: dict = {}


def piece_index(token_strs: Sequence[str]) -> PieceIndex:
    idx = _PIECE_INDEX.get(id(token_strs))
    if idx is None or idx.n != len(token_strs):
        idx = PieceIndex(token_strs)
        _PIECE_INDEX[id(token_strs)] = idx
    return idx


class MetadataFSM:
    """Tracks CoT generation state and constrains the next token.

    Works on the token-string level: call ``step(token_str)`` after each emitted
    token; query ``allowed(token_strs)`` -> bool mask for the candidate vocab.
    """

    def __init__(
        self,
        cfg: Optional[FSMConfig] = None,
        user_metadata: Optional[Dict[str, object]] = None,
    ):
        self.cfg = cfg or FSMConfig()
        self.user = {k: str(v) for k, v in (user_metadata or {}).items()}
        self.tries = {
            "keyscale": TokenTrie(KEYSCALES),
            "language": TokenTrie(LANGUAGES),
            "genres": TokenTrie(list(self.cfg.genres_vocab)),
        }
        self.field_idx = 0
        self.mode = "key"         # key | value | done
        self.value_text = ""
        self.forced_text: Optional[str] = None   # remaining forced chars
        self._begin_field()

    # -- state machinery -----------------------------------------------------

    @property
    def current_field(self) -> Optional[str]:
        if self.field_idx < len(self.cfg.fields):
            return self.cfg.fields[self.field_idx]
        return None

    def _begin_field(self):
        f = self.current_field
        if f is None:
            self.mode = "done"
            self.forced_text = "</think>"
            return
        self.mode = "key"
        self.value_text = ""
        self.forced_text = f"{f}: "

    def _finish_value(self):
        self.field_idx += 1
        self._begin_field()

    def _value_ok(self, f: str, text: str, partial: bool) -> bool:
        if f in FIELD_RANGES:
            if not text:
                return True
            # isascii: "³".isdigit() is True but int("³") raises
            if not text.isdigit() or not text.isascii() or text[0] == "0":
                return False
            lo, hi = FIELD_RANGES[f]
            if partial:
                # valid iff some digit extension lands in [lo, hi]
                max_len = len(str(hi))
                if len(text) > max_len:
                    return False
                v = int(text)
                for extra in range(max_len - len(text) + 1):
                    low = v * 10 ** extra
                    high = low + 10 ** extra - 1
                    if low <= hi and high >= lo:
                        return True
                return False
            return lo <= int(text) <= hi
        if f in self.tries:
            return (text in self.tries[f].prefixes) if partial \
                else self.tries[f].is_complete(text)
        if f == "caption":
            return len(text) <= self.cfg.max_caption_chars and "\n" not in text
        return True

    # -- public API ----------------------------------------------------------

    def _sim_clone(self) -> "MetadataFSM":
        c = object.__new__(MetadataFSM)
        c.cfg = self.cfg
        c.user = self.user
        c.tries = self.tries
        c.field_idx = self.field_idx
        c.mode = self.mode
        c.value_text = self.value_text
        c.forced_text = self.forced_text
        return c

    def allowed_piece(self, piece: str) -> bool:
        """Would emitting token-string ``piece`` keep the output valid?

        Walks the WHOLE piece through a simulated machine, so multi-segment
        tokens ("72\\ntimesignature", "caption text\\ngenres: ") validate
        every segment — a value-ending newline with invalid trailing text is
        rejected instead of silently corrupting the forced-text consumption
        in step()."""
        fsm = self._sim_clone()
        while piece:
            if fsm.forced_text is not None:
                if fsm.forced_text.startswith(piece):
                    return True                       # partial consume
                if not piece.startswith(fsm.forced_text):
                    return False
                rest = piece[len(fsm.forced_text):]
                if fsm.mode == "done":
                    return True                       # trailing after </think>
                fsm.forced_text = None
                fsm.mode = "value"
                piece = rest
                continue
            f = fsm.current_field
            if f is None:
                return False
            if "\n" in piece:
                before, after = piece.split("\n", 1)
                text = fsm.value_text + before
                user_val = fsm.user.get(f)
                if user_val is not None and text != user_val:
                    return False
                if not (fsm._value_ok(f, text, partial=False) and text):
                    return False
                fsm._finish_value()
                piece = after
                continue
            user_val = fsm.user.get(f)
            if user_val is not None:
                target = user_val[len(fsm.value_text):]
                return target.startswith(piece)
            return fsm._value_ok(f, fsm.value_text + piece, partial=True)
        return True

    def _state_sig(self) -> tuple:
        """Content-based state signature: masks for equal signatures are equal,
        so they live in the module-level _MASK_TABLE across FSM instances and
        requests (per-state token-mask tables are static sets)."""
        f = self.current_field
        trie_sig = None
        if self.mode == "value" and f in self.tries:
            trie_sig = self.tries[f].sig
        return (
            f, self.mode, self.forced_text,
            self.value_text if self.mode == "value" else "",
            self.user.get(f) if f else None,
            trie_sig,
        )

    def allowed(self, token_strs: Sequence[str]) -> np.ndarray:
        """Token mask for the whole vocab at the current state.

        Masks are precomputed per FSM STATE and persist in a module-level
        table across instances/requests (the reference precomputes per-state
        token-mask tables, constrained_logits_processor.py:548-648).  Forced-
        text states skip the O(V) string scan entirely via the sorted
        PieceIndex; only novel value states pay one O(V) pass, then hit the
        table forever after."""
        key = (id(token_strs), self._state_sig())
        cached = _MASK_TABLE.get(key)
        if cached is not None:
            return cached
        idx = piece_index(token_strs)
        if self.forced_text is not None:
            mask = idx.forced_mask(self.forced_text)
            # pieces that extend BEYOND the forced text enter the next value
            # span — validate the remainder (forced_mask alone over-allows)
            for i in mask.nonzero()[0]:
                p = token_strs[i]
                if len(p) > len(self.forced_text) and not self.allowed_piece(p):
                    mask[i] = False
        else:
            mask = np.fromiter(
                (self.allowed_piece(t) for t in token_strs), dtype=bool,
                count=len(token_strs),
            )
            mask &= idx.nonempty
        if len(_MASK_TABLE) > 4096:
            _MASK_TABLE.clear()
        _MASK_TABLE[key] = mask
        return mask

    def step(self, piece: str) -> None:
        """Advance the FSM with an emitted token string."""
        if self.forced_text is not None:
            if piece.startswith(self.forced_text):
                # token covered the forced text (and maybe more)
                rest = piece[len(self.forced_text):]
                self.forced_text = None
                if self.mode == "done":
                    return
                self.mode = "value"
                if rest:
                    self.step(rest)
            else:
                self.forced_text = self.forced_text[len(piece):]
            return
        if "\n" in piece:
            self._finish_value()
            trailing = piece.split("\n", 1)[1]
            if trailing:
                self.step(trailing)
            return
        self.value_text += piece

    @property
    def done(self) -> bool:
        return self.mode == "done" and self.forced_text is None


# ---------------------------------------------------------------------------
# compiled token-level DFA (the on-device FSM decode)
#
# The host FSM reads the device's logits and writes back a token every step:
# one host round trip a token.  The masks per FSM state are STATIC sets, so the
# whole machine compiles ahead of time into
#   masks  [S, ceil(V/32)] uint32   per-state allowed-token bitmask
#   default_next [S] + exceptions [S, E] (token, next)  transition table
# and the decode loop keeps its state on the device
# (serving/lm.py generate_with_fsm_device).  The free-text caption span
# collapses to ONE state whose char budget is tracked by a device register
# (cap_len[V] chars per token), exactly matching the host FSM's length rule.
# ---------------------------------------------------------------------------


class DFACompileError(ValueError):
    """DFA exceeds its state/width budget or hit a dead state — caller falls
    back to the host-stepped FSM."""


@dataclasses.dataclass
class CompiledDFA:
    masks_packed: np.ndarray      # [S, W] uint32, W = ceil(V/32)
    default_next: np.ndarray      # [S] int32
    exc_tok: np.ndarray           # [S, E] int32, -1 padded
    exc_next: np.ndarray          # [S, E] int32
    exc_cap: np.ndarray           # [S, E] int32: caption chars carried by exc
    is_caption: np.ndarray        # [S] bool
    cap_len: np.ndarray           # [V] int32: chars before first \n (else len)
    has_nl: np.ndarray            # [V] bool
    max_caption_chars: int
    start_state: int
    done_state: int
    n_states: int
    vocab_size: int

    def host_step(self, state: int, used: int, tok: int):
        """Apply one transition host-side (mirrors the device body exactly):
        returns (next_state, next_used)."""
        hits = self.exc_tok[state] == tok
        if hits.any():
            j = int(hits.argmax())
            return int(self.exc_next[state][j]), used + int(self.exc_cap[state][j])
        delta = int(self.cap_len[tok]) if self.is_caption[state] else 0
        return int(self.default_next[state]), used + delta

    def host_mask(self, state: int, used_chars: int = 0) -> np.ndarray:
        """Unpacked bool mask for ``state`` incl. the caption dynamic rule
        (test/verification hook mirroring the device formula)."""
        row = self.masks_packed[state]
        v = np.arange(self.vocab_size)
        mask = ((row[v // 32] >> (v % 32)) & 1).astype(bool)
        if self.is_caption[state]:
            capm = (used_chars + self.cap_len <= self.max_caption_chars) & (
                ~self.has_nl | (used_chars + self.cap_len > 0)
            )
            mask = mask & capm
        return mask


def _dfa_clone(fsm: MetadataFSM) -> MetadataFSM:
    c = object.__new__(MetadataFSM)
    c.cfg = fsm.cfg
    c.user = fsm.user
    c.tries = fsm.tries
    c.field_idx = fsm.field_idx
    c.mode = fsm.mode
    c.value_text = fsm.value_text
    c.forced_text = fsm.forced_text
    return c


def _dfa_sig(fsm: MetadataFSM):
    if fsm.done:
        return "DONE"
    f = fsm.current_field
    if (f == "caption" and fsm.mode == "value" and fsm.forced_text is None
            and fsm.user.get("caption") is None):
        # caption content never changes the mask or the transitions — only
        # the char budget does, and that lives in a device register
        return ("CAP", fsm.field_idx)
    return (fsm.field_idx, fsm.mode, fsm.forced_text, fsm.value_text)


def _dfa_state_mask(fsm: MetadataFSM, vocab_strs, idx: PieceIndex,
                    nl_ids, digit_ids) -> np.ndarray:
    """fsm.allowed() without the O(V) python scan for value states: candidate
    pieces are enumerated from the field's structure (digit pieces, trie
    prefix extensions) and newline pieces checked individually, then each
    candidate is validated through the SAME allowed_piece predicate."""
    n = len(vocab_strs)
    if fsm.forced_text is not None:
        mask = idx.forced_mask(fsm.forced_text)
        for i in mask.nonzero()[0]:
            p = vocab_strs[i]
            if len(p) > len(fsm.forced_text) and not fsm.allowed_piece(p):
                mask[i] = False
        return mask
    f = fsm.current_field
    mask = np.zeros(n, bool)
    if f is None:
        return mask
    if f == "caption" and fsm.user.get("caption") is None:
        # compile-time: every non-empty piece; budget + nonempty-end rules are
        # the device-side dynamic term (host_mask/device apply identically).
        # newline pieces additionally need their TRAILING segments validated
        # (content-independent): simulate with a nonempty dummy value and an
        # unbounded budget so only the trailing-text check remains
        mask = idx.nonempty.copy()
        sim = _dfa_clone(fsm)
        sim.cfg = dataclasses.replace(fsm.cfg, max_caption_chars=1 << 30)
        sim.value_text = "x"
        for i in nl_ids:
            if mask[i] and not sim.allowed_piece(vocab_strs[i]):
                mask[i] = False
        return mask
    candidates: Set[int] = set()
    user_val = fsm.user.get(f)
    if user_val is not None:
        target = user_val[len(fsm.value_text):]
        for i in idx.forced_mask(target).nonzero()[0]:
            candidates.add(int(i))
    elif f in FIELD_RANGES:
        candidates.update(digit_ids)
    elif f in fsm.tries:
        p = fsm.value_text
        for r in fsm.tries[f].prefixes:
            if r.startswith(p) and len(r) > len(p):
                for i in idx.by_piece.get(r[len(p):], ()):
                    candidates.add(int(i))
    candidates.update(nl_ids)
    for i in candidates:
        if idx.nonempty[i] and fsm.allowed_piece(vocab_strs[i]):
            mask[i] = True
    return mask


def compile_dfa(
    vocab_strs: Sequence[str],
    cfg: Optional[FSMConfig] = None,
    user_metadata: Optional[Dict[str, object]] = None,
    max_states: int = 4096,
    max_exceptions: int = 2048,
) -> CompiledDFA:
    """BFS the reachable FSM states into mask + transition tables.

    Raises DFACompileError when the machine exceeds the budget (huge genres
    vocab / adversarial user metadata) — the caller then uses the host path."""
    fsm0 = MetadataFSM(cfg, user_metadata=user_metadata)
    v = len(vocab_strs)
    idx = piece_index(vocab_strs)
    nl_ids = [i for i, p in enumerate(vocab_strs) if "\n" in p]
    digit_ids = [i for i, p in enumerate(vocab_strs)
                 if p and p.isdigit() and p.isascii()]
    cap_len = np.array(
        [len(p.split("\n", 1)[0]) for p in vocab_strs], np.int32)
    has_nl = np.zeros(v, bool)
    has_nl[nl_ids] = True

    states: Dict[object, int] = {}
    order: List[MetadataFSM] = []

    def state_id(fsm: MetadataFSM) -> int:
        sig = _dfa_sig(fsm)
        sid = states.get(sig)
        if sid is None:
            if len(order) >= max_states:
                raise DFACompileError(
                    f"DFA exceeds {max_states} states (genres vocab too "
                    "large or adversarial user metadata)")
            sid = len(order)
            states[sig] = sid
            order.append(_dfa_clone(fsm))
        return sid

    start = state_id(fsm0)
    masks: List[np.ndarray] = []
    transitions: List[Dict[int, int]] = []
    is_cap: List[bool] = []
    i = 0
    while i < len(order):
        fsm = order[i]
        if fsm.done:
            masks.append(np.zeros(v, bool))
            transitions.append({})
            is_cap.append(False)
            i += 1
            continue
        mask = _dfa_state_mask(fsm, vocab_strs, idx, nl_ids, digit_ids)
        cap_state = _dfa_sig(fsm)[0] == "CAP" if isinstance(_dfa_sig(fsm), tuple) else False
        # dead states (no token keeps the output valid — e.g. a forced-text
        # overshoot fed garbage into a numeric field) are reachable by bad
        # sampling choices; the host loop breaks there, so the DFA marks them
        # absorbing with an empty mask and the device loop stops identically.
        # trans: token -> (next_state, caption_chars_carried): a token that
        # overshoots the "caption: " forced text carries its remainder into
        # the caption value — the device char register must count those chars
        trans: Dict[int, Tuple[int, int]] = {}
        if cap_state:
            # self-loop on every non-newline piece (default, carry=cap_len);
            # only newline pieces leave (carry irrelevant after leaving)
            for t in nl_ids:
                if mask[t]:
                    nxt = _dfa_clone(fsm)
                    nxt.value_text = "x"    # content-free: any nonempty text
                    nxt.step(vocab_strs[t])
                    trans[t] = (state_id(nxt), 0)
        else:
            for t in mask.nonzero()[0]:
                nxt = _dfa_clone(fsm)
                nxt.step(vocab_strs[int(t)])
                sig = _dfa_sig(nxt)
                carry = (len(nxt.value_text)
                         if isinstance(sig, tuple) and sig[0] == "CAP" else 0)
                trans[int(t)] = (state_id(nxt), carry)
        masks.append(mask)
        transitions.append(trans)
        is_cap.append(cap_state)
        i += 1

    s = len(order)
    done_state = states.get("DONE")
    if done_state is None:
        raise DFACompileError("done state unreachable")

    default_next = np.zeros(s, np.int32)
    exc_rows: List[List[Tuple[int, int, int]]] = []
    for sid, trans in enumerate(transitions):
        if is_cap[sid]:
            default_next[sid] = sid          # caption self-loop (carry=cap_len)
            exc_rows.append(sorted((t, nx, cc) for t, (nx, cc) in trans.items()))
        elif not trans:
            default_next[sid] = sid          # absorbing (done)
            exc_rows.append([])
        else:
            # default = most common carry-free successor; nonzero-carry
            # transitions ALWAYS become exceptions (the default path cannot
            # encode their caption-char delta)
            counts: Dict[int, int] = {}
            for nxt, cc in trans.values():
                if cc == 0:
                    counts[nxt] = counts.get(nxt, 0) + 1
            default = max(counts, key=counts.get) if counts else -1
            default_next[sid] = default if default >= 0 else sid
            exc_rows.append(sorted(
                (t, nx, cc) for t, (nx, cc) in trans.items()
                if nx != default or cc != 0))
    e = max((len(r) for r in exc_rows), default=0)
    if e > max_exceptions:
        raise DFACompileError(f"exception width {e} > {max_exceptions}")
    e = max(e, 1)
    exc_tok = np.full((s, e), -1, np.int32)
    exc_next = np.zeros((s, e), np.int32)
    exc_cap = np.zeros((s, e), np.int32)
    for sid, row in enumerate(exc_rows):
        for j, (t, nx, cc) in enumerate(row):
            exc_tok[sid, j] = t
            exc_next[sid, j] = nx
            exc_cap[sid, j] = cc

    w = (v + 31) // 32
    packed = np.zeros((s, w), np.uint32)
    for sid, mask in enumerate(masks):
        bits = np.zeros(w * 32, bool)
        bits[:v] = mask
        packed[sid] = np.packbits(
            bits.reshape(w, 32), axis=1, bitorder="little"
        ).view(np.uint32).reshape(w)

    fsm_cfg = fsm0.cfg
    return CompiledDFA(
        masks_packed=packed,
        default_next=default_next,
        exc_tok=exc_tok,
        exc_next=exc_next,
        exc_cap=exc_cap,
        is_caption=np.asarray(is_cap, bool),
        cap_len=cap_len,
        has_nl=has_nl,
        max_caption_chars=fsm_cfg.max_caption_chars,
        start_state=start,
        done_state=done_state,
        n_states=s,
        vocab_size=v,
    )


def fsm_generate_text(
    fsm: MetadataFSM,
    sample_fn,
    vocab: Sequence[str],
    max_tokens: int = 256,
) -> str:
    """Drive token-by-token generation under the FSM.

    ``sample_fn(mask: np.ndarray[bool]) -> int`` produces the next token id given
    the allowed mask (host hook around the decode step)."""
    out: List[str] = []
    for _ in range(max_tokens):
        if fsm.done:
            break
        mask = fsm.allowed(vocab)
        if not mask.any():
            break
        tok = int(sample_fn(mask))
        piece = vocab[tok]
        out.append(piece)
        fsm.step(piece)
    return "".join(out)
