"""How a mix's clients send their requests: one module a loop kind."""
