"""Engine: config, tokenizer, page allocator, model, sampling, engine, batcher."""
