"""The agent's device path: featurizer, reward, the batched traversal
environment, PPO, behaviour cloning and the PPO-policy agent."""
