"""Source-level lint contracts (CLAUDE.md).

Eager op dispatch pays a launch per op, so any loop-reachable evaluation
MUST go through the jitted protocol (``anytime_eval_jit``). The eager ``anytime_eval`` stays exported as the
single traceable definition (it is what the jit wraps), but no other module
may import or call it directly.
"""

import io
import pathlib
import re
import tokenize

PKG = pathlib.Path(__file__).resolve().parent.parent / "anytime3d_tpu"


def code_only(path: pathlib.Path) -> str:
    """Source with comments and string literals (docstrings) removed."""
    out = []
    toks = tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
    for tok in toks:
        if tok.type not in (tokenize.COMMENT, tokenize.STRING):
            out.append(tok.string)
    return " ".join(out)

# the engine defines anytime_eval and wraps it in jit; __init__ re-exports it
ALLOWED = {PKG / "anytime" / "engine.py", PKG / "anytime" / "__init__.py"}


def test_no_raw_anytime_eval_outside_engine():
    offenders = []
    for path in PKG.rglob("*.py"):
        if path in ALLOWED:
            continue
        src = code_only(path)
        # a bare `anytime_eval` not followed by `_jit` (import or call)
        if re.search(r"\banytime_eval\b(?!_jit)", src):
            offenders.append(str(path))
    assert not offenders, (
        f"raw anytime_eval reachable outside the engine (use anytime_eval_jit; "
        f"eager dispatch pays a launch per op): {offenders}"
    )


def test_no_global_numpy_rng_in_package():
    """The repo style bans global RNG (np.random.<draw> without a Generator);
    seeded ``default_rng`` / RandomState objects are fine."""
    offenders = []
    banned = re.compile(
        r"\bnp\.random\.(rand|randn|randint|uniform|normal|choice|shuffle|permutation)\("
    )
    for path in PKG.rglob("*.py"):
        src = code_only(path)
        if banned.search(src):
            offenders.append(str(path))
    assert not offenders, f"global numpy RNG in package code: {offenders}"
