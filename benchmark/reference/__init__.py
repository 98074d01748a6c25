"""The plain reference: the published model in stock PyTorch, its
weights, its decoding rules, and the comparison that decides
``correct``.  Nothing here imports the program."""
