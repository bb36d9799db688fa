SELECT a.pid, c.pid MATCH (a:Persons)-[e0:Follows]->(b:Persons)-[e1:Follows]->(c:Persons) ON Follows WHERE a.country = 'au' AND c.country = 'uk'
