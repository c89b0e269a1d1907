"""The flagship decoder: config, parameters, prefill and decode math."""
