"""The port's measuring tools, each run as
``python -m scanpaths_tpu_torch.tools.<name>`` (on the card unless given
``--device cpu``); each prints one JSON line per measurement."""
