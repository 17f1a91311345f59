"""The automaton, its count-preserving minimization, the composed case DFA
and the independent NFA oracle."""

from . import ac, case_dfa, nfa_oracle

__all__ = ["ac", "case_dfa", "nfa_oracle"]
