"""Model configs, the Llama decoder and parameter conversion."""
