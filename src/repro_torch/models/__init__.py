"""GQA decoder model of the port: config, layers, attention, stack, LM."""
