"""Host utilities of the port: tokenizer, prompts, profiling."""
