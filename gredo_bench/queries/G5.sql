SELECT p.pid, t.tid MATCH (p:Persons)-[e0:Interested_in]->(t:Tags) ON Interested_in WHERE e0.weight > 0.9
