"""Internationalization: key=value locale files with English fallback.

Behavioral contract: src/i18n.rs — embedded `key=value` text files parsed at
init into lang -> (key -> string) maps behind a global lock, runtime
language switching, English fallback, `t!()` lookup (here: `t()`).
Locale data ships under paintfe_tpu_torch/locales/, the port's own copy
of paintfe_tpu/locales/.
"""

from __future__ import annotations

import pathlib
import threading
from typing import Dict, List, Tuple

# Same 15-language roster as the reference (src/i18n.rs:20-36), including
# its two novelty locales ("be" Bogan English, "fe" Fancy English).
LANGUAGES: List[Tuple[str, str]] = [
    ("en", "English"),
    ("es", "Español"),
    ("fr", "Français"),
    ("de", "Deutsch"),
    ("pt", "Português"),
    ("it", "Italiano"),
    ("ja", "日本語"),
    ("zh-CN", "中文(简体)"),
    ("zh-TW", "中文(繁體)"),
    ("ru", "Русский"),
    ("nl", "Nederlands"),
    ("pl", "Polski"),
    ("tr", "Türkçe"),
    ("be", "Bogan English"),
    ("fe", "Fancy English"),
]

_LOCALES_DIR = pathlib.Path(__file__).resolve().parent.parent / "locales"
_lock = threading.Lock()
_state = {"lang": "en", "translations": None}


def parse_translations(text: str) -> Dict[str, str]:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" in line:
            key, _, value = line.partition("=")
            # the reference trims BOTH sides (i18n.rs:250 val.trim()):
            # 'menu.file = File' is the documented spaced form
            out[key.strip()] = value.strip()
    return out


def init():
    with _lock:
        translations = {}
        if _LOCALES_DIR.exists():
            for path in _LOCALES_DIR.glob("*.txt"):
                translations[path.stem] = parse_translations(path.read_text(encoding="utf-8"))
        translations.setdefault("en", {})
        _state["translations"] = translations


def set_language(lang: str):
    with _lock:
        _state["lang"] = lang


def current_language() -> str:
    return _state["lang"]


def t(key: str) -> str:
    """Translate `key`; falls back to English, then to the key itself."""
    if _state["translations"] is None:
        init()
    with _lock:
        table = _state["translations"].get(_state["lang"], {})
        if key in table:
            return table[key]
        return _state["translations"]["en"].get(key, key)
