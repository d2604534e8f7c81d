"""Host-side data: the tokenizer, the synthetic dataset, batch iteration
and the prefetching loader."""
