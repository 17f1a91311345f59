"""The port's host C++ engine (built with g++ at first use)."""
