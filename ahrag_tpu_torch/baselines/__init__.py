from ahrag_tpu_torch.baselines.naive import NaiveRAG
