"""Runtime data for the native scorers: the authored caption-domain
treebank + its generator (``gen_treebank.py``), the pretrained SPICE
tagger/parser cache, and the compact METEOR synonym table.  A real package
(not a namespace dir) so ``find_packages`` ships it and ``package_data``
can attach the data files."""
