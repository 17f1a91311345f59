"""The automaton and its count-preserving minimization."""
