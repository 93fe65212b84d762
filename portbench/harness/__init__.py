"""The run loop, the traced section and the result line."""
