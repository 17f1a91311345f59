from .automaton import (
    Automaton,
    build_automaton,
    minimum_skip_for_code_point,
    pattern_length,
    pattern_text,
    run_text,
)
from .searcher import Searcher
from .replacer import replace_single_limited

__all__ = [
    "Automaton",
    "build_automaton",
    "minimum_skip_for_code_point",
    "pattern_length",
    "pattern_text",
    "run_text",
    "Searcher",
    "replace_single_limited",
]
