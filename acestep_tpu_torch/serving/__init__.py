"""Serving layer of the port: engine and LM construction and the entry point
(launch), the REST server (api_server), the chat-completions server
(openrouter_server), the continuous batcher, the LM's decode loop and KV
cache.  The JAX package's training and dataset managers are still to be
ported; their routes answer 501."""
